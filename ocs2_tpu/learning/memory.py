"""Circular replay memory as a fixed-size device-resident pytree.

JAX-native analogue of the reference's CircularMemory
(ocs2_mpcnet_core/python/ocs2_mpcnet_core/memory/circular.py).  Instead of a
Python list of torch tensors, the buffer is one preallocated pytree of
[capacity, ...] arrays updated with dynamic_update_slice — push and sample
are jittable, so the whole train step (sample -> loss -> update) fuses into
a single XLA program.
"""
from __future__ import annotations

from typing import Any, NamedTuple

import jax
import jax.numpy as jnp

Array = jax.Array


class CircularMemory(NamedTuple):
    data: Any  # pytree with leading [capacity, ...] axes
    size: Array  # [] int32 — number of valid entries
    head: Array  # [] int32 — next write position

    @staticmethod
    def create(example: Any, capacity: int) -> "CircularMemory":
        data = jax.tree.map(
            lambda a: jnp.zeros((capacity,) + jnp.asarray(a).shape,
                                jnp.asarray(a).dtype),
            example,
        )
        return CircularMemory(
            data=data,
            size=jnp.zeros((), jnp.int32),
            head=jnp.zeros((), jnp.int32),
        )

    @property
    def capacity(self) -> int:
        return jax.tree.leaves(self.data)[0].shape[0]

    def push(self, sample: Any) -> "CircularMemory":
        """Insert one sample at the head (jittable)."""
        data = jax.tree.map(
            lambda buf, s: jax.lax.dynamic_update_index_in_dim(
                buf, jnp.asarray(s, buf.dtype), self.head, 0
            ),
            self.data,
            sample,
        )
        cap = self.capacity
        return CircularMemory(
            data=data,
            size=jnp.minimum(self.size + 1, cap),
            head=(self.head + 1) % cap,
        )

    def push_batch(self, samples: Any) -> "CircularMemory":
        """Insert a [B, ...] batch via scan (jittable, fixed B)."""

        def body(mem, sample):
            return mem.push(sample), None

        mem, _ = jax.lax.scan(body, self, samples)
        return mem

    def sample(self, key: Array, batch_size: int) -> Any:
        """Uniform sample with replacement over the valid region (jittable)."""
        idx = jax.random.randint(key, (batch_size,), 0, jnp.maximum(self.size, 1))
        return jax.tree.map(lambda buf: buf[idx], self.data)
