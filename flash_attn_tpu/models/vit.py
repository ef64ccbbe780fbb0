"""Vision Transformer.

Parity surface for the reference ViT (flash_attn/models/vit.py, timm-style):
patch embed + cls token + pre-norm blocks with flash attention + head,
token/avg global pooling (reference ``global_pool``), and HuggingFace
checkpoint interop (``vit_config_from_hf`` + ``remap_state_dict_hf_vit``
load ``transformers`` ViTForImageClassification weights — query/key/value
fused into Wqkv, torch Conv/Linear weights transposed to this package's layouts).
"""

import dataclasses
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from flash_attn_tpu.modules import core as nn
from flash_attn_tpu import flash_attn_func
from flash_attn_tpu.ops.norm import layer_norm

__all__ = ["ViTConfig", "VisionTransformer", "vit_config_from_hf",
           "remap_state_dict_hf_vit"]


@dataclasses.dataclass(frozen=True)
class ViTConfig:
    img_size: int = 224
    patch_size: int = 16
    in_chans: int = 3
    embed_dim: int = 768
    depth: int = 12
    num_heads: int = 12
    mlp_ratio: float = 4.0
    num_classes: int = 1000
    use_cls_token: bool = True
    global_pool: str = "token"   # "token" (cls) | "avg" (reference option)
    layer_norm_eps: float = 1e-6
    dtype: jnp.dtype = jnp.float32


class _ViTBlock(nn.Module):
    config: ViTConfig

    def __call__(self, x):
        cfg = self.config
        h = cfg.num_heads
        d = cfg.embed_dim // h
        b, s, _ = x.shape
        w1 = self.param("norm1_weight", jax.nn.initializers.ones,
                        (cfg.embed_dim,), jnp.float32)
        b1 = self.param("norm1_bias", jax.nn.initializers.zeros,
                        (cfg.embed_dim,), jnp.float32)
        y = layer_norm(x, w1, b1, cfg.layer_norm_eps)
        qkv = nn.Dense(3 * cfg.embed_dim, dtype=cfg.dtype, name="Wqkv")(y)
        q, k, v = jnp.split(qkv.reshape(b, s, 3, h, d), 3, axis=2)
        attn = flash_attn_func(q[:, :, 0], k[:, :, 0], v[:, :, 0],
                               causal=False)
        attn = nn.Dense(cfg.embed_dim, dtype=cfg.dtype, name="out_proj")(
            attn.reshape(b, s, h * d))
        x = x + attn
        w2 = self.param("norm2_weight", jax.nn.initializers.ones,
                        (cfg.embed_dim,), jnp.float32)
        b2 = self.param("norm2_bias", jax.nn.initializers.zeros,
                        (cfg.embed_dim,), jnp.float32)
        y = layer_norm(x, w2, b2, cfg.layer_norm_eps)
        y = nn.Dense(int(cfg.embed_dim * cfg.mlp_ratio), dtype=cfg.dtype,
                     name="fc1")(y)
        y = jax.nn.gelu(y, approximate=False)
        y = nn.Dense(cfg.embed_dim, dtype=cfg.dtype, name="fc2")(y)
        return x + y


class VisionTransformer(nn.Module):
    config: ViTConfig

    def __call__(self, images):  # (b, H, W, C)
        cfg = self.config
        b = images.shape[0]
        x = nn.Conv(cfg.embed_dim, (cfg.patch_size, cfg.patch_size),
                    strides=(cfg.patch_size, cfg.patch_size),
                    dtype=cfg.dtype, name="patch_embed")(images)
        x = x.reshape(b, -1, cfg.embed_dim)
        n = x.shape[1]
        if cfg.use_cls_token:
            cls = self.param("cls_token", jax.nn.initializers.zeros,
                             (1, 1, cfg.embed_dim), jnp.float32)
            x = jnp.concatenate(
                [jnp.broadcast_to(cls, (b, 1, cfg.embed_dim)).astype(x.dtype),
                 x], axis=1)
            n += 1
        pos = self.param("pos_embed",
                         jax.nn.initializers.normal(0.02),
                         (1, n, cfg.embed_dim), jnp.float32)
        x = x + pos.astype(x.dtype)
        for i in range(cfg.depth):
            x = _ViTBlock(cfg, name=f"blocks_{i}")(x)
        w = self.param("norm_weight", jax.nn.initializers.ones,
                       (cfg.embed_dim,), jnp.float32)
        bb = self.param("norm_bias", jax.nn.initializers.zeros,
                        (cfg.embed_dim,), jnp.float32)
        x = layer_norm(x, w, bb, cfg.layer_norm_eps)
        if cfg.global_pool == "token" and cfg.use_cls_token:
            feat = x[:, 0]
        else:  # "avg": mean over patch tokens (cls excluded, timm semantics)
            feat = x[:, 1:].mean(axis=1) if cfg.use_cls_token \
                else x.mean(axis=1)
        return nn.Dense(cfg.num_classes, dtype=jnp.float32, name="head")(feat)


# ---------------------------------------------------------------------------
# HuggingFace interop (transformers ViTForImageClassification)
# ---------------------------------------------------------------------------

def vit_config_from_hf(hf_config, num_classes: int,
                       dtype=jnp.float32) -> ViTConfig:
    return ViTConfig(
        img_size=hf_config.image_size,
        patch_size=hf_config.patch_size,
        in_chans=hf_config.num_channels,
        embed_dim=hf_config.hidden_size,
        depth=hf_config.num_hidden_layers,
        num_heads=hf_config.num_attention_heads,
        mlp_ratio=hf_config.intermediate_size / hf_config.hidden_size,
        num_classes=num_classes,
        use_cls_token=True,
        layer_norm_eps=hf_config.layer_norm_eps,
        dtype=dtype,
    )


def remap_state_dict_hf_vit(state_dict, cfg: ViTConfig):
    """HF ViTForImageClassification state_dict -> params."""
    sd = {k: np.asarray(v.float().numpy() if hasattr(v, "float") else v)
          for k, v in state_dict.items()}

    def dense(prefix):
        return {"kernel": jnp.asarray(sd[prefix + ".weight"].T),
                "bias": jnp.asarray(sd[prefix + ".bias"])}

    p = {
        "cls_token": jnp.asarray(sd["vit.embeddings.cls_token"]),
        "pos_embed": jnp.asarray(sd["vit.embeddings.position_embeddings"]),
        "patch_embed": {
            # torch Conv (out, in, kh, kw) -> (kh, kw, in, out)
            "kernel": jnp.asarray(
                sd["vit.embeddings.patch_embeddings.projection.weight"]
                .transpose(2, 3, 1, 0)),
            "bias": jnp.asarray(
                sd["vit.embeddings.patch_embeddings.projection.bias"]),
        },
        "norm_weight": jnp.asarray(sd["vit.layernorm.weight"]),
        "norm_bias": jnp.asarray(sd["vit.layernorm.bias"]),
        "head": dense("classifier"),
    }
    for i in range(cfg.depth):
        pre = f"vit.encoder.layer.{i}."
        wq = sd[pre + "attention.attention.query.weight"]
        wk = sd[pre + "attention.attention.key.weight"]
        wv = sd[pre + "attention.attention.value.weight"]
        bq = sd[pre + "attention.attention.query.bias"]
        bk = sd[pre + "attention.attention.key.bias"]
        bv = sd[pre + "attention.attention.value.bias"]
        p[f"blocks_{i}"] = {
            "Wqkv": {"kernel": jnp.asarray(
                         np.concatenate([wq, wk, wv], axis=0).T),
                     "bias": jnp.asarray(np.concatenate([bq, bk, bv]))},
            "out_proj": dense(pre + "attention.output.dense"),
            "fc1": dense(pre + "intermediate.dense"),
            "fc2": dense(pre + "output.dense"),
            "norm1_weight": jnp.asarray(sd[pre + "layernorm_before.weight"]),
            "norm1_bias": jnp.asarray(sd[pre + "layernorm_before.bias"]),
            "norm2_weight": jnp.asarray(sd[pre + "layernorm_after.weight"]),
            "norm2_bias": jnp.asarray(sd[pre + "layernorm_after.bias"]),
        }
    return p
