"""The device mesh of the port (the port of the mesh half of
stract_tpu/parallel/mesh.py).

The JAX package runs its multi-device programs under one controller over a
jax.sharding.Mesh; the port keeps that model. A Mesh here is an array of
torch.device entries with axis names, and an entry may repeat: four shards
can sit on one card, as the JAX tests put eight shards on one CPU. The
programs that run over it (parallel/search.py, the sharded HyperBall in
webgraph/centrality.py) loop over the shards from one process, and the
collectives become copies to the owning device (`Tensor.to`: no copy when
the shards share a card, a peer copy between cards).

The flax sharding rules of the JAX module (AXIS_RULES, rules_for_mesh,
shard_params) serve the encoders' sharded training and are not ported.
"""

from __future__ import annotations

import numpy as np
import torch


def _device_array(devices) -> np.ndarray:
    """Any nesting of devices (torch.device or names) → an object array of
    torch.device of the same shape."""
    given = np.asarray(devices, dtype=object)
    arr = np.empty(given.size, dtype=object)
    arr[:] = [torch.device(d) for d in given.reshape(-1)]
    return arr.reshape(given.shape)


class Mesh:
    """An array of torch.device entries (repeats allowed) with one name per
    axis: `.devices` (the object array), `.axis_names`, and `.shape`, the
    size of each named axis, as jax.sharding.Mesh."""

    def __init__(self, devices, axis_names=("x",)):
        self.devices = _device_array(devices)
        self.axis_names = tuple(axis_names)
        if self.devices.ndim != len(self.axis_names):
            raise ValueError(f"a mesh of shape {self.devices.shape} needs "
                             f"{self.devices.ndim} axis names, not {self.axis_names}")
        if self.devices.size == 0:
            raise ValueError("a mesh holds at least one device")

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.devices.shape))

    def __repr__(self) -> str:
        return f"Mesh({[str(d) for d in self.devices.flat]}, shape={self.shape})"


def _factor(n: int, ways: int) -> list[int]:
    """Split n into `ways` factors by distributing its prime factors round-robin
    (8, 3 → [2, 2, 2]; 4, 3 → [2, 2, 1]; 6, 3 → [3, 2, 1])."""
    primes = []
    f, d = n, 2
    while f > 1:
        while f % d == 0:
            primes.append(d)
            f //= d
        d += 1
    dims = [1] * ways
    for i, p in enumerate(sorted(primes, reverse=True)):
        dims[i % ways] *= p
    return dims


def make_mesh(n_devices: int | None = None, axes=("dp", "tp", "sp"), device="cuda") -> Mesh:
    """A mesh over the first n_devices cards (all of them by default), shaped
    by _factor over `axes`. device="cpu" builds n_devices CPU entries
    (default 1), as the CPU tests do; "cuda" without a card raises."""
    if torch.device(device).type == "cuda":
        count = torch.cuda.device_count()
        if count == 0:
            raise RuntimeError("device 'cuda' was asked for and there is no CUDA card")
        devices = [torch.device("cuda", i) for i in range(count)][: n_devices or count]
    else:
        devices = [torch.device(device)] * (n_devices or 1)
    dims = _factor(len(devices), len(axes))
    return Mesh(_device_array(devices).reshape(dims), axis_names=axes)
