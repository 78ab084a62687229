"""Document-partitioned search over a mesh of shards — the port of
stract_tpu/parallel/search.py (the product's multi-chip serving path: each
shard holds one segment, scores it, and the shards' top-k lists merge into
one global top-k).

The JAX package runs each program as one shard_map over the mesh: per device
its stage A and stage B, then an all-gather of every device's top K and one
lax.top_k. The port runs the same program from one controller: per shard the
stage-A and joined stage-B kernels on the shard's device (ops/scoring.py),
the "all-gather" a copy of each shard's top K to the mesh's first device (no
copy when the shards share a card), and the global top-k the mesh merge
kernel (ops.scoring.mesh_topk_lists, K9), which reads each shard's list
where it lies. Launches are queued for every shard, and for every query of a
batch, before anything is fetched.

The cross-host layer (distributed/, gossip + sonic) still fans out between
processes; this module is the fan-out inside one process, where the shards
are mesh entries.
"""

from __future__ import annotations

import threading

import numpy as np
import torch

from ..device import resolve_device
from ..ops import scoring as O


def _stack_leaf(xs):
    if all(isinstance(x, torch.Tensor) for x in xs):
        return torch.stack(list(xs))
    return torch.from_numpy(np.stack([np.asarray(x) for x in xs]))


def stack_segment_arrays(segs: list) -> O.SegmentArrays:
    """Stack per-shard SegmentArrays along a new leading shard axis. All
    segments must share shapes (pad_segments_to_common_shapes)."""
    return type(segs[0])(*[_stack_leaf(xs) for xs in zip(*segs)])


def pad_segments_to_common_shapes(dev_segments: list) -> list:
    """Pad differently sized segments (DeviceSegments, or their SegmentArrays)
    with zeros to one shape per field, so they stack (shards are built
    independently, so their bucketed shapes can differ by one bucket)."""
    arrays = [getattr(d, "arrays", d) for d in dev_segments]
    out = [[] for _ in arrays]
    for leaves in zip(*arrays):
        ts = [x if isinstance(x, torch.Tensor) else torch.as_tensor(np.asarray(x))
              for x in leaves]
        shape = tuple(int(v) for v in np.max([tuple(t.shape) for t in ts], axis=0)) \
            if ts[0].dim() else ()
        for i, t in enumerate(ts):
            if tuple(t.shape) != shape:
                p = torch.zeros(shape, dtype=t.dtype, device=t.device)
                p[tuple(slice(0, s) for s in t.shape)] = t
                t = p
            out[i].append(t)
    return [type(arrays[0])(*leaves) for leaves in out]


def _pad_slots(q, maxP: int):
    """Pad a QuerySlots to maxP inert slots (len 0, OPTIONAL group)."""
    cur = q.starts.shape[0]
    if cur >= maxP:
        return q
    pad = maxP - cur
    return q._replace(
        starts=np.pad(np.asarray(q.starts), (0, pad)),
        lens=np.pad(np.asarray(q.lens), (0, pad)),
        group=np.pad(np.asarray(q.group), (0, pad), constant_values=O.OPTIONAL_GROUP),
        idf=np.pad(np.asarray(q.idf), (0, pad)),
        w_bm25=np.pad(np.asarray(q.w_bm25), (0, pad)),
        w_bm25f=np.pad(np.asarray(q.w_bm25f), (0, pad)),
        w_presence=np.pad(np.asarray(q.w_presence), (0, pad)),
    )


def _devices(mesh) -> list:
    return [resolve_device(d) for d in mesh.devices.flat]


def _check_shards(per_shard: list, n: int) -> list:
    if len(per_shard) != n:
        raise ValueError(f"{len(per_shard)} shards for a mesh of {n}")
    return per_shard


def _merge(parts: list, dev, k: int):
    """The all-gather of each shard's (docs, scores) [B, K] to `dev` (no copy
    where a shard lies there), then the global top k over the shards' lists
    where they lie → (docs, shards, scores) [B, k]."""
    return O.mesh_topk_lists([s.to(dev) for _, s in parts], [d.to(dev) for d, _ in parts], k)


def sharded_two_stage_batch(mesh, segs, qas: list, qcs: list, L: int, C: int, K: int,
                            default_static: bool, fast: bool, merge: bool = False):
    """The serving program over a batch of queries: per shard d, stage A in
    soft-required mode over qas[d] (QuerySlots [B, Pa], impact-augmented;
    `fast` as its static mode), the exact stage B over qcs[d] (compacted
    [B, Pc] slots) with the factors joined on the device, then the merge →
    (docs i32[B, K], shards i32[B, K], scores f32[B, K]) on the mesh's first
    device. segs: one SegmentArrays per shard."""
    devs = _devices(mesh)
    parts = []
    for seg, qa, qc, dev in zip(_check_shards(segs, len(devs)), qas, qcs, devs):
        seg = O.to_tensors(seg, dev)
        cand, _ = O.score_candidates_batch(seg, qa, L, C, fast, soft_required=True, merge=merge)
        parts.append(O.score_driver_joined_batch(seg, qc, cand, default_static, K))
    return _merge(parts, devs[0], K)


def make_sharded_search(mesh, L: int = O.DEFAULT_L, K: int = O.DEFAULT_K,
                        default_static: bool = True):
    """→ fn(segs, q) → (docs i32[K], shards i32[K], scores f32[K]) globally
    ranked across every shard's segment (segs: one SegmentArrays per shard,
    where the JAX package's program takes them stacked): per shard stage A
    (top K) with the one query q, then the merge."""
    devs = _devices(mesh)

    def fn(segs, q):
        parts = []
        for seg, dev in zip(_check_shards(segs, len(devs)), devs):
            docs, scores = O.score_candidates_batch(O.to_tensors(seg, dev), O.stack([q]), L, K,
                                                    default_static)
            parts.append((docs, scores))
        docs, shards, scores = _merge(parts, devs[0], K)
        return docs[0], shards[0], scores[0]

    return fn


def make_sharded_two_stage(mesh, L: int = O.DEFAULT_L, C: int = 2048, K: int = O.DEFAULT_K,
                           default_static: bool = True, fast: bool = True, merge: bool = False):
    """The serving program for one query → fn(segs, qas, qcs) → (docs
    i32[K], shards i32[K], scores f32[K]); per shard a SegmentArrays, qa =
    impact-augmented slots (stage A), qc = compacted original slots (stage
    B: the augmented prefixes would double-count), where the JAX package's
    program takes each stacked."""
    n = len(_devices(mesh))

    def fn(segs, qas, qcs):
        qas = [O.stack([q]) for q in _check_shards(qas, n)]
        qcs = [O.stack([q]) for q in _check_shards(qcs, n)]
        docs, shards, scores = sharded_two_stage_batch(mesh, segs, qas, qcs, L, C, K,
                                                       default_static, fast, merge)
        return docs[0], shards[0], scores[0]

    return fn


class MeshShardedSearcher:
    """The multi-shard serving path LocalSearcher takes when it is given a
    mesh of more than one entry: the index's segments are distributed one per
    mesh entry, and every query runs the two-stage program above
    (stage A, stage B joined on the device, the merge) in place of the
    per-segment loop of the single-device path.

    Contract (the JAX package's): fewer segments than shards pad with
    zero-doc clones of shard 0; driver-eligible queries take the
    single-device exact path; one L, Pa, Pc, C and K per query across the
    shards; every query's launches are queued before the first fetch; a
    result is valid where its score is finite and its doc is below its
    shard's doc count. The stage-A join order (the merge network or not) and
    the row layout are the index's (InvertedIndex arguments); UB scoring is
    not used here, as in the JAX package.

    The JAX package pads every segment's arrays to one shape to stack them
    for its shard_map; here each shard runs its own launches, so each keeps
    its own shapes (padding changes no result)."""

    def __init__(self, index, mesh):
        self.index = index
        self.mesh = mesh
        self.devices = _devices(mesh)
        self.n = len(self.devices)
        self._segments = [s for s in index.segments if s.num_docs > 0]
        if not (0 < len(self._segments) <= self.n):
            raise ValueError(
                f"need 1..{self.n} non-empty segments for a {self.n}-shard mesh, "
                f"got {len(self._segments)}")
        self._num_docs = [s.num_docs for s in self._segments] + [0] * (self.n - len(self._segments))
        shards = [O.to_tensors(index.device_segment_for(s).arrays, self.devices[d])
                  for d, s in enumerate(self._segments)]
        # zero-doc clones of shard 0 (num_docs = 0 makes every doc invalid, so
        # they contribute nothing to the merge)
        empty = shards[0]._replace(num_docs=torch.tensor(0, dtype=torch.int32))
        while len(shards) < self.n:
            shards.append(O.to_tensors(empty, self.devices[len(shards)]))
        self._shards = shards
        # queries searched, and those of them the single-device exact path took
        self.stats = {"queries": 0, "driver": 0}
        self._stats_lock = threading.Lock()

    def search_batch(self, ctxs: list, top_k: int = 1024) -> list:
        """Same contract as InvertedIndex.search_initial_batch: → list of
        (pointers, scores) aligned with ctxs."""
        from ..index.inverted import SCAN_CANDIDATES, DocPointer, _nonneg, _qshape
        from ..ranking.computer import choose_L, uses_default_static

        idx = self.index
        region_scores = idx.region_scores()
        total = idx.num_docs
        dfl = idx._df_lookup()
        K_out = _qshape(top_k, (512, O.DEFAULT_K))
        C = _qshape(max(SCAN_CANDIDATES, top_k), (1024, 2048, 4096))

        groups: dict = {}  # one launch of the program per shape: queries batched
        driver_qis: list = []  # queries routed through the exact single-device path
        for qi, ctx in enumerate(ctxs):
            ctx._segments = self._segments  # pointer ordinals index this snapshot
            ds = uses_default_static(ctx)
            qas, qcs, Ls = [], [], []
            nonneg = True
            is_driver = False
            for ord_, seg in enumerate(self._segments):
                q, _ = idx._slots_for(ctx, ord_, seg, total, region_scores, dfl)
                # driver-eligible (a selective required group): the program's
                # L-prefix stage A can miss matches past the prefix, so these
                # take the exact path (the full-range driver verify)
                if idx._driver_docs(seg, q) is not None:
                    is_driver = True
                    break
                L = choose_L(np.asarray(q.lens))
                qa, _ub, _ubt = idx._augment_with_impact(seg, idx.device_segment_for(seg), q, L)
                qc, _ = idx._compact_slots(q, min_p=16)
                nonneg = nonneg and _nonneg(q)
                qas.append(qa)
                qcs.append(qc)
                Ls.append(L)
            if is_driver:
                driver_qis.append(qi)
                continue
            L = _qshape(max(Ls), (128, O.DEFAULT_L))
            Pa = _qshape(max(q.starts.shape[0] for q in qas), (16, 64))
            Pc = _qshape(max(q.starts.shape[0] for q in qcs), (16, 64))
            qas = [_pad_slots(q, Pa) for q in qas] + [_pad_slots(qas[-1], Pa)] * (self.n - len(qas))
            qcs = [_pad_slots(q, Pc) for q in qcs] + [_pad_slots(qcs[-1], Pc)] * (self.n - len(qcs))
            groups.setdefault((L, Pa, Pc, ds, ds and nonneg), []).append((qi, qas, qcs))

        with self._stats_lock:
            self.stats["queries"] += len(ctxs)
            self.stats["driver"] += len(driver_qis)
        pending = []
        for (L, _, _, ds, fast), items in groups.items():
            qas = [O.stack([it[1][d] for it in items]) for d in range(self.n)]
            qcs = [O.stack([it[2][d] for it in items]) for d in range(self.n)]
            res = sharded_two_stage_batch(self.mesh, self._shards, qas, qcs, L, C, K_out, ds,
                                          fast, merge=idx.merge_kernel)
            pending.append((res, [it[0] for it in items]))

        out: list = [None] * len(ctxs)
        if driver_qis:
            for qi, res in zip(driver_qis, idx.search_initial_batch(
                    [ctxs[qi] for qi in driver_qis], top_k=top_k)):
                out[qi] = res
        nd_all = np.asarray(self._num_docs)
        for (docs_t, shards_t, scores_t), qis in pending:
            docs_b, shards_b, scores_b = (t.cpu().numpy() for t in (docs_t, shards_t, scores_t))
            for j, qi in enumerate(qis):
                docs, shards, scores = docs_b[j], shards_b[j], scores_b[j]
                valid = np.isfinite(scores) & (docs < nd_all[shards])
                ptrs = [DocPointer(int(s), int(d))
                        for s, d in zip(shards[valid][:top_k], docs[valid][:top_k])]
                out[qi] = (ptrs, [float(x) for x in scores[valid][:top_k]])
        return out
