"""Plain-JAX module plumbing for the model layer.

A model is a frozen dataclass of hyperparameters whose ``__call__(s, g,
x, ...)`` takes a :class:`Scope` first. The scope hands out parameters by
name: while initializing it creates them from the init key, while
applying it reads them from the ``{"params": ...}`` dict. So one function
body serves both passes, and the public surface is

    params = Model(...).init(rng, g, x, **kw)["params"]
    y = Model(...).apply({"params": params}, g, x, **kw)

``apply(..., rngs={"dropout": key})`` supplies the dropout key; each
dropout site folds its own scope path and call count into it.
"""

from __future__ import annotations

import zlib
from typing import Any, Optional

import jax
import jax.numpy as jnp

_init = jax.nn.initializers


def _fold(key, name: str):
    return jax.random.fold_in(key, zlib.crc32(name.encode()) & 0x7FFFFFFF)


class Scope:
    """Named parameter access for one module path (init or apply)."""

    def __init__(self, params: dict, *, init_key=None, dropout_key=None):
        self.params = params
        self.init_key = init_key
        self.dropout_key = dropout_key
        self._dropout_calls = 0

    @property
    def initializing(self) -> bool:
        return self.init_key is not None

    def param(self, name: str, init_fn, shape, dtype=jnp.float32):
        if self.initializing and name not in self.params:
            self.params[name] = init_fn(_fold(self.init_key, name), shape,
                                        dtype)
        return self.params[name]

    def child(self, name: str) -> "Scope":
        if self.initializing:
            sub = self.params.setdefault(name, {})
            key = _fold(self.init_key, name)
        else:
            sub, key = self.params[name], None
        dk = None if self.dropout_key is None else _fold(self.dropout_key,
                                                         name)
        return Scope(sub, init_key=key, dropout_key=dk)

    def make_dropout_key(self):
        if self.dropout_key is None:
            raise ValueError(
                "dropout with deterministic=False needs "
                "apply(..., rngs={'dropout': key})")
        self._dropout_calls += 1
        return jax.random.fold_in(self.dropout_key, self._dropout_calls)


class Module:
    """Base for models: frozen dataclasses (hashable by value — ``apply``
    is a jit-static field of the train state) that define
    ``__call__(self, s, g, x, ...)``."""

    def init(self, rng, *args, **kwargs) -> dict:
        params: dict = {}
        kwargs.pop("rngs", None)
        self(Scope(params, init_key=rng), *args, **kwargs)
        return {"params": params}

    def apply(self, variables: dict, *args, rngs: Optional[dict] = None,
              **kwargs) -> Any:
        dk = None if rngs is None else rngs.get("dropout")
        return self(Scope(variables["params"], dropout_key=dk),
                    *args, **kwargs)


def dense(s: Scope, x, features: int, *, use_bias: bool = True,
          dtype=None, param_dtype=jnp.float32):
    """``x @ kernel + bias``; ``dtype`` (if set) is the compute dtype of
    both operands, accumulation stays f32."""
    kernel = s.param("kernel", _init.lecun_normal(),
                     (x.shape[-1], features), param_dtype)
    dt = dtype or jnp.result_type(x.dtype, kernel.dtype)
    y = jnp.dot(x.astype(dt), kernel.astype(dt),
                preferred_element_type=jnp.float32).astype(dt)
    if use_bias:
        y = y + s.param("bias", _init.zeros, (features,),
                        param_dtype).astype(dt)
    return y


def layer_norm(s: Scope, x, *, dtype=None, eps: float = 1e-6):
    """LayerNorm over the last axis, statistics in f32."""
    f = x.shape[-1]
    scale = s.param("scale", _init.ones, (f,))
    bias = s.param("bias", _init.zeros, (f,))
    x32 = x.astype(jnp.float32)
    mean = x32.mean(-1, keepdims=True)
    var = jnp.square(x32 - mean).mean(-1, keepdims=True)
    y = (x32 - mean) * jax.lax.rsqrt(var + eps) * scale + bias
    return y.astype(dtype or x.dtype)


def dropout(s: Scope, x, rate: float, deterministic: bool):
    if rate == 0.0 or deterministic:
        return x
    keep = 1.0 - rate
    mask = jax.random.bernoulli(s.make_dropout_key(), keep, x.shape)
    return jnp.where(mask, x / keep, 0).astype(x.dtype)


def remat_call(s: Scope, name: str, fn, x, *, remat: bool):
    """Run ``fn(child_scope, x)`` under the child scope ``name``; with
    ``remat`` the call is a ``jax.checkpoint`` over (params, x), so its
    activations are recomputed in the backward instead of stored."""
    c = s.child(name)
    if not remat or c.initializing:
        return fn(c, x)

    def body(params, x, dk):
        return fn(Scope(params, dropout_key=dk), x)

    return jax.checkpoint(body, prevent_cse=True)(c.params, x,
                                                 c.dropout_key)
