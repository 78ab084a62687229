"""WordPiece tokenizer (host-side) for the BERT encoders.

Role of the reference's `tokenizers` crate usage (models/dual_encoder.rs,
ranking/models/cross_encoder.rs). Self-contained so no HF hub access is needed:
loads a vocab.txt, or builds a character/word vocab from a corpus for tests.
Greedy longest-match-first with ## continuation pieces (standard WordPiece).
"""

from __future__ import annotations

import numpy as np

PAD, UNK, CLS, SEP, MASK = "[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"
SPECIALS = [PAD, UNK, CLS, SEP, MASK]


def trim_to_bucket(ids: np.ndarray, mask: np.ndarray, types: np.ndarray,
                   min_len: int = 16):
    """Cut a [B, max_len] encoded batch down to the smallest power-of-2
    sequence bucket that holds the batch's longest row. The truncation cap
    (the reference's 128/256-token limits) is enforced by encode_batch; most
    real inputs — queries, titles — are far shorter, and a BERT forward is
    linear in padded length, so serving at the fixed cap wastes 3-10× compute
    on BOTH comparison arms. Trimmed columns are all-PAD with mask 0, which
    contribute nothing to masked attention or masked mean-pooling, so outputs
    are bit-identical per bucket shape. A handful of buckets keeps the jit
    cache small."""
    n = int(mask.sum(axis=1).max()) if len(mask) else 0
    b = min_len
    while b < n:
        b *= 2
    b = min(b, ids.shape[1])
    return ids[:, :b], mask[:, :b], types[:, :b]


def _basic_tokens(text: str) -> list[str]:
    out = []
    buf = []
    for ch in text.lower():
        if ch.isalnum():
            buf.append(ch)
        else:
            if buf:
                out.append("".join(buf))
                buf = []
            if not ch.isspace():
                out.append(ch)
    if buf:
        out.append("".join(buf))
    return out


class WordPieceTokenizer:
    def __init__(self, vocab: dict[str, int], max_input_chars_per_word: int = 100):
        self.vocab = vocab
        self.inv = {v: k for k, v in vocab.items()}
        self.max_chars = max_input_chars_per_word
        self.pad_id = vocab[PAD]
        self.unk_id = vocab[UNK]
        self.cls_id = vocab[CLS]
        self.sep_id = vocab[SEP]
        self._memo: dict[str, list[int]] = {}

    # -- construction ---------------------------------------------------------
    @classmethod
    def from_vocab_file(cls, path: str) -> "WordPieceTokenizer":
        vocab = {}
        with open(path, encoding="utf-8") as fh:
            for i, line in enumerate(fh):
                vocab[line.rstrip("\n")] = i
        return cls(vocab)

    @classmethod
    def build(cls, texts: list[str], vocab_size: int = 1000) -> "WordPieceTokenizer":
        """Tiny trainer for tests: specials + chars + most frequent words."""
        from collections import Counter

        words = Counter()
        chars = set()
        for t in texts:
            for w in _basic_tokens(t):
                words[w] += 1
                chars.update(w)
        vocab = {s: i for i, s in enumerate(SPECIALS)}
        for ch in sorted(chars):
            if ch not in vocab:
                vocab[ch] = len(vocab)
            cont = "##" + ch
            if cont not in vocab:
                vocab[cont] = len(vocab)
        for w, _ in words.most_common():
            if len(vocab) >= vocab_size:
                break
            if w not in vocab:
                vocab[w] = len(vocab)
        return cls(vocab)

    # -- encoding ----------------------------------------------------------------
    def wordpiece(self, word: str) -> list[int]:
        # word-level memo: zipf text repeats words constantly, and the greedy
        # longest-match scan is the hot loop of every encoder call (serving
        # cross-encoder pairs, bulk doc embedding). Bounded so a crawl of
        # unbounded unique tokens can't grow the dict forever.
        cached = self._memo.get(word)
        if cached is not None:
            return cached
        ids = self._wordpiece_uncached(word)
        if len(self._memo) >= 1_000_000:
            self._memo.clear()
        self._memo[word] = ids
        return ids

    def _wordpiece_uncached(self, word: str) -> list[int]:
        if len(word) > self.max_chars:
            return [self.unk_id]
        ids = []
        start = 0
        while start < len(word):
            end = len(word)
            cur = None
            while start < end:
                piece = word[start:end]
                if start > 0:
                    piece = "##" + piece
                if piece in self.vocab:
                    cur = self.vocab[piece]
                    break
                end -= 1
            if cur is None:
                return [self.unk_id]
            ids.append(cur)
            start = end
        return ids

    def encode(self, text_a: str, text_b: str | None = None, max_len: int = 128):
        """→ (input_ids, attention_mask, token_type_ids) np.int32[max_len]."""
        ids_a = [i for w in _basic_tokens(text_a) for i in self.wordpiece(w)]
        ids_b = [i for w in _basic_tokens(text_b) for i in self.wordpiece(w)] if text_b else []

        if text_b:
            # [CLS] a [SEP] b [SEP]; truncate longest-first
            while len(ids_a) + len(ids_b) > max_len - 3:
                if len(ids_a) >= len(ids_b):
                    ids_a.pop()
                else:
                    ids_b.pop()
            ids = [self.cls_id] + ids_a + [self.sep_id] + ids_b + [self.sep_id]
            types = [0] * (len(ids_a) + 2) + [1] * (len(ids_b) + 1)
        else:
            ids_a = ids_a[: max_len - 2]
            ids = [self.cls_id] + ids_a + [self.sep_id]
            types = [0] * len(ids)

        n = len(ids)
        input_ids = np.full(max_len, self.pad_id, dtype=np.int32)
        input_ids[:n] = ids
        mask = np.zeros(max_len, dtype=np.int32)
        mask[:n] = 1
        type_ids = np.zeros(max_len, dtype=np.int32)
        type_ids[:n] = types
        return input_ids, mask, type_ids

    def encode_batch(self, pairs: list, max_len: int = 128):
        """pairs: list of str or (a, b) tuples → stacked np arrays [B, max_len]."""
        if pairs and all(isinstance(p, str) for p in pairs):
            # single-text fast path (bulk doc embedding): one [B, L] fill
            # instead of 3 array allocations per text
            B = len(pairs)
            ids = np.full((B, max_len), self.pad_id, dtype=np.int32)
            mask = np.zeros((B, max_len), dtype=np.int32)
            types = np.zeros((B, max_len), dtype=np.int32)
            cls_id, sep_id = self.cls_id, self.sep_id
            wp = self.wordpiece
            for r, text in enumerate(pairs):
                row = [cls_id]
                for w in _basic_tokens(text):
                    row.extend(wp(w))
                    if len(row) > max_len - 2:
                        break
                del row[max_len - 1:]
                row.append(sep_id)
                n = len(row)
                ids[r, :n] = row
                mask[r, :n] = 1
            return ids, mask, types
        enc = [
            self.encode(p, None, max_len) if isinstance(p, str) else self.encode(p[0], p[1], max_len)
            for p in pairs
        ]
        ids = np.stack([e[0] for e in enc])
        mask = np.stack([e[1] for e in enc])
        types = np.stack([e[2] for e in enc])
        return ids, mask, types
