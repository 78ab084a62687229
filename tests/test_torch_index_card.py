"""The index build's card path: entrypoint/indexer.py run with the dual
encoder on the card (its title and keyword embeddings through K5a-d) writes
the index the CPU plain path writes. Every file byte-equal but the embedding
matrices, which agree within the encoder kernels' tolerance against their
plain versions (max abs 2e-2 a row, as test_torch_models.py holds the
embeddings, plus the f16 store's rounding: atol 2e-2 + 1e-3). Imports the
port alone; skips without a card.
"""

from __future__ import annotations

import itertools
import os
import uuid
from unittest import mock

import numpy as np
import pytest
import torch

from stract_tpu_torch import warc_corpus as WC
from stract_tpu_torch.entrypoint import indexer as IX
from stract_tpu_torch.index.segment import Segment
from stract_tpu_torch.models.bert import BertConfig
from stract_tpu_torch.models.dual_encoder import DualEncoder
from stract_tpu_torch.models.wordpiece import WordPieceTokenizer
from stract_tpu_torch.ops import kernels

EMB_ATOL = 2e-2 + 1e-3


def _run(warcs, out, dual, device):
    """indexer.run with the clocks and segment names pinned."""
    ticks, ids = itertools.count(), itertools.count(1)
    with mock.patch("time.time", return_value=1_700_000_000.0), \
            mock.patch("time.perf_counter", side_effect=lambda: next(ticks) * 0.0037), \
            mock.patch("uuid.uuid4", side_effect=lambda: uuid.UUID(int=next(ids) << 80)):
        return IX.run(warcs, out, IX.IndexingWorker(dual_encoder=dual),
                      embedding_dim=dual.embedding_dim, device=device)


@pytest.mark.cuda
def test_indexer_embeddings_on_the_card_match_the_cpu(tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card and nvcc")
    info = WC.write_warcs(str(tmp_path / "warc"), files=1, pages=80, seed=3, hosts=20,
                          words=(40, 200))
    rng = np.random.default_rng(0)
    tok = WordPieceTokenizer.build([WC.page(rng, 0, i, info.hosts, (40, 80))[1]
                                    for i in range(40)], vocab_size=1024)
    DualEncoder.random_init(BertConfig.mini_lm(vocab_size=len(tok.vocab)), tok, seed=2,
                            device="cpu").save(str(tmp_path / "dual"))
    a = _run(info.paths, str(tmp_path / "cpu"),
             DualEncoder.load(str(tmp_path / "dual"), device="cpu"), "cpu")
    kernels.reset_launches()
    b = _run(info.paths, str(tmp_path / "card"),
             DualEncoder.load(str(tmp_path / "dual"), device="cuda"), "cuda")
    for name in ("attention", "add_layernorm", "bias_gelu", "mean_pool"):
        assert kernels.LAUNCHES[name] > 0, name
    assert b.num_docs == a.num_docs == info.pages - info.noindex
    for root, _, files in os.walk(a.path):
        for f in files:
            pa = os.path.join(root, f)
            pb = os.path.join(b.path, os.path.relpath(pa, a.path))
            if f.endswith("_embeddings.bin"):
                continue
            with open(pa, "rb") as x, open(pb, "rb") as y:
                assert x.read() == y.read(), os.path.relpath(pa, a.path)
    sa, sb = Segment(a.segments[0].path), Segment(b.segments[0].path)
    for field in ("title_embeddings", "keyword_embeddings"):
        ea = np.asarray(sa.embeddings(field), np.float32)
        eb = np.asarray(sb.embeddings(field), np.float32)
        assert ea.shape == eb.shape and np.abs(ea - eb).max() <= EMB_ATOL, field
