"""Parameter-scoped modules in plain JAX.

A model is a tree of :class:`Module` dataclasses. ``model.init(rng, *args)``
runs the forward once and returns ``{"params": ...}`` (plus any other
collection it created); ``model.apply(variables, *args, mutable=[...])``
runs it against given variables and, when ``mutable`` is set, also returns
the updated collections. Inside a method, ``self.param`` and
``self.variable`` read (or, while initializing, create) entries at the
module's path in the nested variable dicts.

A child module's path element is its explicit ``name``, else the attribute
it is assigned to in ``setup`` (``attr_i`` for lists), else
``ClassName_i`` in call order. These are the rules flax.linen uses, so the
param-tree key layout (``Wqkv/kernel``, ``layers_0/mixer/...``) is the one
checkpoints and the HF adapters (models/hf_adapters.py) map.
"""

import dataclasses
import functools
import inspect
import zlib
from typing import Any, Callable, Optional

import jax
import jax.numpy as jnp

__all__ = ["Module", "Dense", "Embed", "Conv", "dropout"]

# Modules whose methods are running, innermost last. A module constructed
# while one runs becomes its child.
_STACK = []


class _Frame:
    """Variables, rngs and mutability of one init/apply call."""

    def __init__(self, variables, rngs, mutable, initializing):
        self.variables = variables
        self.rngs = rngs
        self.mutable = mutable
        self.initializing = initializing
        self.rng_counts = {}

    def is_mutable(self, collection: str) -> bool:
        return (self.initializing or self.mutable is True
                or collection in self.mutable)


def _copy_dicts(tree):
    if isinstance(tree, dict):
        return {k: _copy_dicts(v) for k, v in tree.items()}
    return tree


def _path_salt(path) -> int:
    return zlib.crc32("/".join(path).encode())


class _Variable:
    """Handle on one variable; ``.value`` reads and writes it."""

    def __init__(self, module, collection, name):
        self._module, self._collection, self._name = (
            module, collection, name)

    @property
    def value(self):
        return self._module._scope(self._collection)[self._name]

    @value.setter
    def value(self, v):
        if not self._module._frame.is_mutable(self._collection):
            raise ValueError(f"collection {self._collection!r} is not "
                             "mutable in this apply")
        self._module._scope(self._collection, create=True)[self._name] = v


def _bound_method(fn):
    @functools.wraps(fn)
    def wrapped(self, *args, **kwargs):
        self._bind()
        _STACK.append(self)
        try:
            if not self._setup_done:
                self._setup_done = True
                self.setup()
            return fn(self, *args, **kwargs)
        finally:
            _STACK.pop()
    return wrapped


@dataclasses.dataclass(eq=False)
class Module:
    name: Optional[str] = dataclasses.field(default=None, kw_only=True)

    def __init_subclass__(cls, **kwargs):
        super().__init_subclass__(**kwargs)
        fields = cls.__dict__.get("__annotations__", {})
        for attr, val in list(cls.__dict__.items()):
            if attr == "setup" or attr in fields or (
                    attr.startswith("_") and attr != "__call__"):
                continue
            if inspect.isfunction(val):
                setattr(cls, attr, _bound_method(val))
        dataclasses.dataclass(cls, eq=False)

    def __post_init__(self):
        object.__setattr__(self, "_parent", _STACK[-1] if _STACK else None)
        object.__setattr__(self, "_frame", None)
        object.__setattr__(self, "_path", None)
        object.__setattr__(self, "_setup_done", False)
        object.__setattr__(self, "_autonames", {})

    def setup(self):
        """Override to build submodules once per bound instance."""

    def __setattr__(self, attr, value):
        # submodules assigned in setup are named after the attribute
        if isinstance(value, Module) and value.name is None:
            value.name = attr
        elif isinstance(value, (list, tuple)):
            for i, m in enumerate(value):
                if isinstance(m, Module) and m.name is None:
                    m.name = f"{attr}_{i}"
        object.__setattr__(self, attr, value)

    # -- binding -----------------------------------------------------------
    def _bind(self):
        if self._frame is not None:
            return
        parent = self._parent
        if parent is None or parent._frame is None:
            raise RuntimeError(
                f"{type(self).__name__} is not bound: call it through "
                "init/apply of its root module")
        if self.name is None:
            cls = type(self).__name__
            i = parent._autonames.get(cls, 0)
            parent._autonames[cls] = i + 1
            self.name = f"{cls}_{i}"
        object.__setattr__(self, "_path", parent._path + (self.name,))
        object.__setattr__(self, "_frame", parent._frame)

    def _scope(self, collection, create=False):
        d = self._frame.variables.get(collection)
        if d is None:
            if not create:
                raise KeyError(f"no {collection!r} collection")
            d = self._frame.variables[collection] = {}
        for p in self._path:
            if p not in d:
                if not create:
                    raise KeyError(f"{collection}/{'/'.join(self._path)} "
                                   "not found")
                d[p] = {}
            d = d[p]
        return d

    def is_initializing(self) -> bool:
        return self._frame.initializing

    def param(self, name: str, init_fn: Callable, *init_args):
        self._bind()
        scope = self._scope("params", create=self._frame.initializing)
        if name not in scope:
            if not self._frame.initializing:
                raise KeyError(
                    f"params/{'/'.join(self._path + (name,))} not found")
            key = jax.random.fold_in(self._frame.rngs["params"],
                                     _path_salt(self._path + (name,)))
            scope[name] = init_fn(key, *init_args)
        return scope[name]

    def variable(self, collection: str, name: str, init_fn: Callable,
                 *init_args) -> _Variable:
        self._bind()
        try:
            exists = name in self._scope(collection)
        except KeyError:
            exists = False
        if not exists:
            if not self._frame.is_mutable(collection):
                raise KeyError(f"{collection}/{'/'.join(self._path)}/{name} "
                               "not found and the collection is immutable")
            self._scope(collection, create=True)[name] = init_fn(*init_args)
        return _Variable(self, collection, name)

    def make_rng(self, name: str):
        self._bind()
        counts = self._frame.rng_counts
        key = (self._path, name)
        counts[key] = counts.get(key, 0) + 1
        rng = jax.random.fold_in(self._frame.rngs[name],
                                 _path_salt(self._path))
        return jax.random.fold_in(rng, counts[key])

    # -- entry points --------------------------------------------------------
    def _run(self, variables, rngs, mutable, initializing, method, args,
             kwargs):
        root = dataclasses.replace(self)
        object.__setattr__(root, "_parent", None)
        object.__setattr__(root, "_path", ())
        object.__setattr__(root, "_frame",
                           _Frame(variables, rngs, mutable, initializing))
        if method is None:
            fn = root.__call__
        elif isinstance(method, str):
            fn = getattr(root, method)
        else:
            fn = getattr(root, method.__name__)
        return fn(*args, **kwargs), root._frame.variables

    def init(self, rngs, *args, method=None, **kwargs):
        """Run once, creating variables; returns every collection made."""
        if not isinstance(rngs, dict):
            rngs = {"params": rngs}
        _, variables = self._run({}, rngs, True, True, method, args, kwargs)
        return variables

    def apply(self, variables, *args, rngs=None, method=None,
              mutable=False, **kwargs):
        """Run against ``variables``; with ``mutable`` (a collection name,
        a list of them, or True) return (out, updated collections)."""
        if isinstance(mutable, str):
            mutable = [mutable]
        mutable = mutable if mutable is True else frozenset(mutable or ())
        variables = {col: (_copy_dicts(tree) if mutable is True
                           or col in mutable else tree)
                     for col, tree in variables.items()}
        out, variables = self._run(variables, dict(rngs or {}), mutable,
                                   False, method, args, kwargs)
        if not mutable:
            return out
        return out, {col: tree for col, tree in variables.items()
                     if mutable is True or col in mutable}


class Dense(Module):
    """y = x @ kernel (+ bias); params float32, computed in ``dtype``."""
    features: int
    use_bias: bool = True
    dtype: Any = None
    kernel_init: Callable = jax.nn.initializers.lecun_normal()

    def __call__(self, x):
        kernel = self.param("kernel", self.kernel_init,
                            (x.shape[-1], self.features), jnp.float32)
        dtype = self.dtype or jnp.result_type(x, kernel)
        y = jax.lax.dot_general(x.astype(dtype), kernel.astype(dtype),
                                (((x.ndim - 1,), (0,)), ((), ())))
        if self.use_bias:
            bias = self.param("bias", jax.nn.initializers.zeros,
                              (self.features,), jnp.float32)
            y = y + bias.astype(dtype)
        return y


class Embed(Module):
    """Table lookup; ``attend`` is the weight-tied output projection."""
    num_embeddings: int
    features: int
    dtype: Any = jnp.float32

    def _table(self):
        return self.param(
            "embedding",
            jax.nn.initializers.variance_scaling(1.0, "fan_in", "normal",
                                                 out_axis=0),
            (self.num_embeddings, self.features), jnp.float32)

    def __call__(self, ids):
        return jnp.take(self._table().astype(self.dtype), ids, axis=0)

    def attend(self, query):
        table = self._table().astype(self.dtype)
        return jnp.dot(query.astype(self.dtype), table.T)


class Conv(Module):
    """2-D convolution over NHWC inputs, SAME padding."""
    features: int
    kernel_size: tuple
    strides: tuple = (1, 1)
    dtype: Any = jnp.float32

    def __call__(self, x):
        kernel = self.param(
            "kernel", jax.nn.initializers.lecun_normal(),
            (*self.kernel_size, x.shape[-1], self.features), jnp.float32)
        bias = self.param("bias", jax.nn.initializers.zeros,
                          (self.features,), jnp.float32)
        y = jax.lax.conv_general_dilated(
            x.astype(self.dtype), kernel.astype(self.dtype),
            window_strides=self.strides, padding="SAME",
            dimension_numbers=("NHWC", "HWIO", "NHWC"))
        return y + bias.astype(self.dtype)


def dropout(x, rate: float, rng):
    """Inverted dropout: keep with probability 1 - rate, scale up."""
    keep = jax.random.bernoulli(rng, 1.0 - rate, x.shape)
    return jnp.where(keep, x / (1.0 - rate), 0).astype(x.dtype)
