"""Encoder training entry points, the port of
stract_tpu/entrypoint/train_encoders.py: fine-tune the dual and cross
encoder BERTs on (query, relevant, irrelevant) triples synthesised from an
index's own documents, then save serving checkpoints (models/store.py) that
either package loads.

Triple synthesis (a click-log surrogate): query = a few terms sampled from a
document's title/body, positive = that document's title + body window,
negative = a random other document that holds none of the query terms. The
same index and seed give the same triples as the JAX package, and the same
`default_rng(seed)` draws pick the same batches.

The models start from the port's own random init (torch, from `seed`), not
from the JAX package's (its PRNG keys give other numbers). Training runs on
one `device` (the JAX package pjits over its mesh): the dual encoder with
InfoNCE over the B x B similarity, the cross encoder with the pairwise loss,
optionally warm-started from a trained dual trunk and distilled from it.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from ..device import resolve_device
from ..index.inverted import DocPointer, InvertedIndex
from ..models.bert import BertConfig, BertForEmbedding, random_init
from ..models.wordpiece import WordPieceTokenizer
from ..parallel.train import (
    distill_loss, info_nce_loss, make_train_state, pairwise_loss, train_step,
)


def _index(index) -> InvertedIndex:
    """An index directory or an open index; the trainers read stored docs
    only, so a path opens on the host."""
    return index if isinstance(index, InvertedIndex) else InvertedIndex(index, "cpu")


def synthesize_triples(index, n: int, seed: int = 0, q_terms: tuple = (2, 3),
                       body_window: int = 30) -> list:
    """→ [(query, pos_text, neg_text)] sampled from the index's stored docs."""
    index = _index(index)
    rng = np.random.default_rng(seed)
    sizes = [(ord_, s.num_docs) for ord_, s in enumerate(index.segments) if s.num_docs > 0]
    if not sizes:
        raise ValueError("empty index")
    total = sum(c for _, c in sizes)
    bounds = np.cumsum([c for _, c in sizes])

    def rand_ptr():
        g = int(rng.integers(0, total))
        si = int(np.searchsorted(bounds, g, side="right"))
        ord_, cnt = sizes[si]
        off = g - (int(bounds[si - 1]) if si else 0)
        return DocPointer(ord_, off)

    # draw in rounds with rejection: a negative that contains a query term is
    # a false negative (the reference measured held-out accuracy at chance
    # until this filter was added)
    triples = []
    attempts = 0
    while len(triples) < n and attempts < 6 * n:
        m = min(2 * (n - len(triples)), 2 * n)
        attempts += m
        docs = index.retrieve([rand_ptr() for _ in range(2 * m)])
        for i in range(m):
            pos, neg = docs[2 * i], docs[2 * i + 1]
            stored_p = pos.get("stored", pos)
            stored_n = neg.get("stored", neg)
            text = (stored_p.get("title", "") + " " + stored_p.get("clean_text", "")).split()
            if not text:
                continue
            k = int(rng.integers(q_terms[0], q_terms[1] + 1))
            q_words = list(rng.choice(text, size=min(k, len(text)), replace=False))
            body_p = " ".join(stored_p.get("clean_text", "").split()[:body_window])
            body_n = " ".join(stored_n.get("clean_text", "").split()[:body_window])
            pos_text = (stored_p.get("title", "") + " " + body_p).strip()
            neg_text = (stored_n.get("title", "") + " " + body_n).strip()
            neg_words = set(neg_text.split())
            if any(w in neg_words for w in q_words):
                continue
            if pos_text and neg_text and pos_text != neg_text:
                triples.append((" ".join(q_words), pos_text, neg_text))
            if len(triples) >= n:
                break
    return triples


def _fit_tokenizer(triples: list, vocab_size: int) -> WordPieceTokenizer:
    texts = [t for tri in triples for t in tri]
    return WordPieceTokenizer.build(texts, vocab_size=vocab_size)


def corpus_tokenizer(index, vocab_size: int = 30522, n_docs: int = 50_000,
                     seed: int = 0) -> WordPieceTokenizer:
    """WordPiece vocab fit on a uniform sample of the index's stored docs
    (the reference's MiniLM-class encoders ship a 30,522-piece vocab; with
    nothing to download, a vocab of that size is fit on the corpus)."""
    index = _index(index)
    rng = np.random.default_rng(seed)
    texts = []
    sizes = [(ord_, s.num_docs) for ord_, s in enumerate(index.segments) if s.num_docs > 0]
    total = sum(c for _, c in sizes)
    bounds = np.cumsum([c for _, c in sizes])
    picks = rng.integers(0, total, size=min(n_docs, total))
    for lo in range(0, len(picks), 4096):
        ptrs = []
        for g in picks[lo : lo + 4096]:
            si = int(np.searchsorted(bounds, int(g), side="right"))
            ord_, _ = sizes[si]
            ptrs.append(DocPointer(ord_, int(g) - (int(bounds[si - 1]) if si else 0)))
        for d in index.retrieve(ptrs):
            s = d.get("stored", d)
            texts.append(s.get("title", "") + " " + s.get("clean_text", ""))
    return WordPieceTokenizer.build(texts, vocab_size=vocab_size)


def _tensors(dev, **arrays) -> dict:
    return {k: torch.from_numpy(np.ascontiguousarray(a)).to(dev) for k, a in arrays.items()}


def _finish(dev, t0: float, steps: int, timing: dict | None) -> None:
    if timing is not None:
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        timing.update(steps=steps, seconds=time.perf_counter() - t0)


def train_cross_encoder(index_path, out_path: str, steps: int = 120,
                        batch: int = 16, max_len: int = 64, n_triples: int = 512,
                        cfg: BertConfig | None = None, seed: int = 0, lr: float = 3e-4,
                        tokenizer: WordPieceTokenizer | None = None,
                        save_max_len: int | None = None,
                        warm_start: str | None = None, distill: bool = False,
                        teacher_scale: float = 5.0, distill_alpha: float = 0.5,
                        log=print, device="cuda", timing: dict | None = None) -> list:
    """Pairwise-ranking fine-tune, saved as a serving checkpoint → the loss
    curve. `timing`, when given, receives the step loop's steps and seconds.

    warm_start: a trained dual-encoder checkpoint whose BERT trunk (its f32
    masters) seeds the cross encoder; only the score head stays random, and
    the dual encoder's tokenizer replaces `tokenizer`. The reference measured
    from-scratch pairwise training on a 6-layer trunk memorising or
    flat-lining; starting from the contrastive trunk converges the head.

    distill (requires warm_start): add alpha x the per-example MSE to the dual
    teacher's scaled cosines (its targets computed once over the whole pool,
    by the serving DualEncoder.embed)."""
    from ..models.dual_encoder import DualEncoder
    from ..models.store import load_encoder
    from ..ranking.models.cross_encoder import CrossEncoderModel

    dev = resolve_device(device)
    cfg = cfg or BertConfig.tiny()
    triples = synthesize_triples(index_path, n_triples, seed=seed)
    tok = tokenizer or _fit_tokenizer(triples, cfg.vocab_size)

    rng = np.random.default_rng(seed)
    losses = []
    teacher = None
    model, opt = make_train_state(cfg, learning_rate=lr, device=dev)
    if warm_start:
        t_cfg, masters, t_tok, _ = load_encoder(warm_start, "dual")
        if t_cfg.hidden_size != cfg.hidden_size or t_cfg.num_layers != cfg.num_layers:
            raise ValueError(f"warm-start shape mismatch: {t_cfg} vs {cfg}")
        trunk = {k[len("bert."):]: v for k, v in masters.items() if k.startswith("bert.")}
        with torch.no_grad():  # into the optimizer's flat buffer, in place
            for name, p in model.bert.named_parameters():
                p.copy_(trunk[name].to(p.dtype))
        tok = t_tok  # the trunk's embeddings are tied to its vocab
        teacher = DualEncoder.load(warm_start, device=dev)
    t_pos = t_neg = None
    if distill:
        if teacher is None:
            raise ValueError("distill=True requires warm_start (the teacher)")

        def _emb(texts):
            return np.concatenate([teacher.embed(texts[lo : lo + 512])
                                   for lo in range(0, len(texts), 512)])

        qe = _emb([t[0] for t in triples])
        t_pos = teacher_scale * (qe * _emb([t[1] for t in triples])).sum(1)
        t_neg = teacher_scale * (qe * _emb([t[2] for t in triples])).sum(1)
        log(f"[cross] teacher targets ready (pos μ {t_pos.mean():.2f}, "
            f"neg μ {t_neg.mean():.2f})")
    t0 = time.perf_counter()
    for it in range(steps):
        pick = rng.integers(0, len(triples), batch)
        qs = [triples[j][0] for j in pick]
        p_ids, p_mask, p_types = tok.encode_batch(
            [(q, triples[j][1]) for q, j in zip(qs, pick)], max_len)
        n_ids, n_mask, n_types = tok.encode_batch(
            [(q, triples[j][2]) for q, j in zip(qs, pick)], max_len)
        feed = _tensors(dev, pos_ids=p_ids, pos_mask=p_mask, pos_types=p_types,
                        neg_ids=n_ids, neg_mask=n_mask, neg_types=n_types)
        if distill:
            feed.update(_tensors(dev, t_pos=t_pos[pick].astype(np.float32),
                                 t_neg=t_neg[pick].astype(np.float32)))
            loss = train_step(model, opt, feed, distill_loss, alpha=distill_alpha)
        else:
            loss = train_step(model, opt, feed, pairwise_loss)
        losses.append(float(loss))
        if it % 20 == 0:
            log(f"[cross] step {it} loss {losses[-1]:.4f}")
    _finish(dev, t0, steps, timing)
    CrossEncoderModel.from_masters(cfg, model, tok,
                                   max_len=save_max_len or max_len).save(out_path)
    log(f"[cross] saved → {out_path} (loss {losses[0]:.3f} → {losses[-1]:.3f})")
    return losses


def train_dual_encoder(index_path, out_path: str, steps: int = 120,
                       batch: int = 32, max_len: int = 48, n_triples: int = 512,
                       cfg: BertConfig | None = None, seed: int = 0, lr: float = 3e-4,
                       temperature: float = 20.0,
                       tokenizer: WordPieceTokenizer | None = None,
                       save_max_len: int | None = None, log=print, device="cuda",
                       timing: dict | None = None) -> list:
    """In-batch-negative contrastive fine-tune (InfoNCE over the B x B
    similarity: every other doc of the batch is a negative), saved as a
    serving checkpoint for both the embedding columns and the recall stage
    → the loss curve. `timing` as in train_cross_encoder."""
    from ..models.dual_encoder import DualEncoder
    from ..optim import AdamW

    dev = resolve_device(device)
    cfg = cfg or BertConfig.tiny()
    triples = synthesize_triples(index_path, n_triples, seed=seed)
    tok = tokenizer or _fit_tokenizer(triples, cfg.vocab_size)

    model = random_init(BertForEmbedding(cfg, param_dtype=torch.float32), seed).to(dev)
    opt = AdamW(model.parameters(), lr)
    rng = np.random.default_rng(seed)
    losses = []
    t0 = time.perf_counter()
    for it in range(steps):
        pick = rng.integers(0, len(triples), batch)
        q_ids, q_mask, _ = tok.encode_batch([triples[j][0] for j in pick], max_len)
        d_ids, d_mask, _ = tok.encode_batch([triples[j][1] for j in pick], max_len)
        feed = _tensors(dev, q_ids=q_ids, q_mask=q_mask, d_ids=d_ids, d_mask=d_mask)
        losses.append(float(train_step(model, opt, feed, info_nce_loss,
                                       temperature=temperature)))
        if it % 20 == 0:
            log(f"[dual] step {it} loss {losses[-1]:.4f}")
    _finish(dev, t0, steps, timing)
    DualEncoder.from_masters(cfg, model, tok, max_len=save_max_len or max_len).save(out_path)
    log(f"[dual] saved → {out_path} (loss {losses[0]:.3f} → {losses[-1]:.3f})")
    return losses
