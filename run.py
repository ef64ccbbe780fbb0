#!/usr/bin/env python
"""Config-file training entry point.

The reference launches training as ``python run.py experiment=owt/gpt2s-flash``
with a Hydra config tree (/root/reference/training/run.py +
training/configs/experiment/*.yaml). This equivalent keeps the same shape
without a Hydra dependency: a JSON experiment file maps onto the
GPTConfig / TrainConfig dataclasses, and dotted ``key=value`` CLI overrides
compose on top (Hydra's override grammar, restricted to assignments).

    python run.py experiment=configs/experiment/gpt-small.json \
        trainer.total_steps=200 model.n_layer=12 data.path=/data/owt.bin

Config schema (every key optional — defaults are the dataclass defaults):

    {
      "model":   { ... GPTConfig fields ... },
      "trainer": { ... TrainConfig fields (minus model) ... },
      "data":    { "path": "tokens.bin", "dtype": "uint16",
                   "val_path": null, "seed": 0 },
      "eval":    { "every": 0, "steps": 20 }
    }

``trainer.seqlen`` drives both the dataloader and the model; ``data.path``
may be omitted for a smoke run on synthetic tokens (deterministic PRNG
stream — useful for CI and for compile-cache warmup on a new machine).
"""

import argparse
import dataclasses
import json
import sys
from typing import Any, Dict

import numpy as np


def _coerce(val: str, typ) -> Any:
    if typ is bool or isinstance(typ, bool):
        return val.lower() in ("1", "true", "yes")
    for cast in (int, float):
        try:
            return cast(val)
        except ValueError:
            continue
    if val.lower() in ("null", "none"):
        return None
    if val.lower() in ("true", "false"):
        return val.lower() == "true"
    return val


def parse_args(argv):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("assignments", nargs="*",
                    help="experiment=<file.json> plus dotted overrides "
                         "(model.n_layer=12 trainer.lr=3e-4 data.path=...)")
    ns = ap.parse_args(argv)
    cfg: Dict[str, Any] = {}
    for a in ns.assignments:
        if "=" not in a:
            ap.error(f"expected key=value, got {a!r}")
        key, val = a.split("=", 1)
        if key == "experiment":
            with open(val) as f:
                loaded = json.load(f)
            for sect, body in loaded.items():
                cfg.setdefault(sect, {}).update(body)
            continue
        parts = key.split(".")
        node = cfg
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = _coerce(val, None)
    return cfg


def build(cfg: Dict[str, Any]):
    import jax.numpy as jnp

    from flash_attn_tpu.models.gpt import GPTConfig
    from flash_attn_tpu.training.trainer import TrainConfig, Trainer

    def mk(dc, body, **extra):
        fields = {f.name for f in dataclasses.fields(dc)}
        unknown = set(body) - fields
        if unknown:
            raise SystemExit(f"unknown {dc.__name__} keys: {sorted(unknown)}")
        body = dict(body)
        if "dtype" in body:
            body["dtype"] = jnp.dtype(body["dtype"]).type
        return dc(**body, **extra)

    model_cfg = mk(GPTConfig, cfg.get("model", {}))
    train_cfg = mk(TrainConfig, cfg.get("trainer", {}), model=model_cfg)
    return Trainer(train_cfg), train_cfg


def make_dataloader(cfg: Dict[str, Any], train_cfg, path_key="path"):
    from flash_attn_tpu.training.data import (FaultTolerantSampler,
                                              LMDataLoader, TokenDataset)

    data = cfg.get("data", {})
    path = data.get(path_key)
    if path is None:
        if path_key != "path":
            return None

        def synthetic():
            rng = np.random.default_rng(data.get("seed", 0))
            b, s = train_cfg.batch_size, train_cfg.seqlen
            vocab = train_cfg.model.vocab_size
            while True:
                ids = rng.integers(0, vocab, size=(b, s + 1), dtype=np.int32)
                yield ids[:, :-1], ids[:, 1:]

        return synthetic()
    ds = TokenDataset(path, dtype=np.dtype(data.get("dtype", "uint16")),
                      seqlen=train_cfg.seqlen)
    sampler = FaultTolerantSampler(len(ds), seed=data.get("seed", 0))
    return LMDataLoader(ds, train_cfg.batch_size, sampler=sampler)


def main(argv=None):
    from flash_attn_tpu.utils.runtime import configure_compile_cache

    configure_compile_cache()
    cfg = parse_args(sys.argv[1:] if argv is None else argv)
    trainer, train_cfg = build(cfg)
    loader = make_dataloader(cfg, train_cfg)
    val_loader = make_dataloader(cfg, train_cfg, path_key="val_path")
    ev = cfg.get("eval", {})
    trainer.fit(loader, val_dataloader=val_loader,
                eval_every=ev.get("every", 0), eval_steps=ev.get("steps", 20))
    return trainer


if __name__ == "__main__":
    main()
