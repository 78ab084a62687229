"""The reverse CSR the graph kernels walk (K6a, K7 in csrc/graph.cu): for
every target node, the sources of its in-edges, on the device.

A graph in the store already holds it (`in_offsets`, `in_sources`, sorted by
(to, from)); `graph_in_csr` copies it to the device. For a raw edge list,
`in_csr` sorts the edges by target on the device. Either gives the same
arrays for the same edges. Targets with more than LONG_ROW in-edges are
listed apart: the kernels give each of them a whole block.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

# rows with more in-edges than this take a whole block in the kernels
LONG_ROW = 64


class InCSR(NamedTuple):
    """Edges sorted by target, on the device: offsets i32[N + 1] into
    sources i32[E]; long_rows i32[L], the targets with more than LONG_ROW
    in-edges."""
    offsets: torch.Tensor
    sources: torch.Tensor
    long_rows: torch.Tensor


def _check_edges(e: int) -> None:
    if e >= 2 ** 31:
        raise ValueError("the graph kernels index edges with int32")


def in_csr(n: int, edge_from, edge_to, device) -> InCSR:
    """The reverse CSR of the edge list (u → v) on `device`, sorted there.
    Any order of a target's in-edges gives the same max and min."""
    ef = torch.as_tensor(np.asarray(edge_from), dtype=torch.int64).to(device)
    et = torch.as_tensor(np.asarray(edge_to), dtype=torch.int64).to(device)
    _check_edges(ef.numel())
    order = torch.argsort(et, stable=True)
    counts = torch.bincount(et, minlength=n)
    offsets = torch.zeros(n + 1, dtype=torch.int64, device=ef.device)
    offsets[1:] = torch.cumsum(counts, 0)
    long_rows = torch.nonzero(counts > LONG_ROW).flatten()
    return InCSR(offsets.to(torch.int32), ef[order].to(torch.int32).contiguous(),
                 long_rows.to(torch.int32).contiguous())


def graph_in_csr(graph, device) -> InCSR:
    """The store's reverse CSR of `graph` (a webgraph.store.Webgraph) on
    `device`."""
    off = np.asarray(graph.in_offsets, dtype=np.int64)
    _check_edges(int(off[-1]))
    long_rows = np.flatnonzero(np.diff(off) > LONG_ROW).astype(np.int32)
    return InCSR(torch.from_numpy(off.astype(np.int32)).to(device),
                 torch.from_numpy(np.asarray(graph.in_sources, dtype=np.int32)).to(device),
                 torch.from_numpy(long_rows).to(device))
