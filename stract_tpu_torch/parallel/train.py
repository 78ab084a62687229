"""Training steps for the encoders, the port of stract_tpu/parallel/train.py
(the cross encoder's pairwise step, plain and distilled) plus the dual
encoder's InfoNCE loss of stract_tpu/entrypoint/train_encoders.py:246-251.

The JAX package runs these as pjit programs over a (dp, tp, sp, ep) mesh.
The port trains on one card: the mesh and its sharding arguments are gone,
`make_train_state` builds a dense-FFN BertForSequenceScore only (it raises
on `num_experts > 0`: the MoE FFN is not ported), and the orbax train-state
checkpoints (parallel/train.py:127-149) are not ported; trained models are
saved as serving checkpoints by the entry points.

A step: the forward of both sides of the batch through the encoder in its
training form (f32 masters cast per call; K5a-d), the loss, autograd back
through K14a-c and the cuBLAS products, then the fused AdamW update
(optim.py, K14d). The loss heads (the pairwise softplus, the MSE to the
teacher, the B x B InfoNCE logits and their cross-entropy) are torch ops on
a few hundred numbers, not kernels.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..models.bert import BertConfig, BertForSequenceScore, random_init
from ..optim import AdamW


def ranking_loss(scores_pos, scores_neg):
    """Pairwise logistic loss: -log σ(s+ − s−) = softplus(s− − s+), mean."""
    x = -(scores_pos - scores_neg)
    return torch.logaddexp(x, torch.zeros_like(x)).mean()


def make_train_state(cfg: BertConfig, learning_rate: float = 1e-4, seed: int = 0,
                     num_experts: int = 0, device="cuda"):
    """A cross encoder with f32 masters (random init from `seed`) on
    `device`, and its optimizer → (model, opt)."""
    if num_experts:
        raise ValueError("the MoE FFN (num_experts > 0) is not ported")
    model = random_init(BertForSequenceScore(cfg, param_dtype=torch.float32), seed).to(device)
    return model, AdamW(model.parameters(), learning_rate)


def _pair_scores(model, batch):
    # token-type ids must match serving (the cross encoder's score passes
    # them): the reference measured untrained segment-B embeddings inverting
    # pos/neg order on held-out pairs
    s_pos = model(batch["pos_ids"], batch["pos_mask"], batch.get("pos_types"))
    s_neg = model(batch["neg_ids"], batch["neg_mask"], batch.get("neg_types"))
    return s_pos, s_neg


def pairwise_loss(model, batch):
    """batch: pos_ids / pos_mask / neg_ids / neg_mask (+ *_types) int32[B, T]."""
    return ranking_loss(*_pair_scores(model, batch))


def distill_loss(model, batch, alpha: float = 0.5):
    """Pairwise loss + alpha x the MSE of each side's score to the teacher's
    target (batch["t_pos"], batch["t_neg"]: f32[B])."""
    s_pos, s_neg = _pair_scores(model, batch)
    reg = ((s_pos - batch["t_pos"]) ** 2).mean() + ((s_neg - batch["t_neg"]) ** 2).mean()
    return ranking_loss(s_pos, s_neg) + alpha * reg


def info_nce_loss(model, batch, temperature: float = 20.0):
    """The dual encoder's in-batch-negative loss: cross-entropy of the B x B
    similarity of L2-normalised query and doc embeddings, times
    `temperature`, against the diagonal. batch: q_ids / q_mask / d_ids /
    d_mask int32[B, T]."""
    qe = model(batch["q_ids"], batch["q_mask"])
    de = model(batch["d_ids"], batch["d_mask"])
    logits = (qe @ de.T) * temperature
    return F.cross_entropy(logits, torch.arange(logits.shape[0], device=logits.device))


def train_step(model, opt: AdamW, batch, loss_fn=pairwise_loss, **loss_kw) -> torch.Tensor:
    """One step: zero the gradients, loss, backward, AdamW → the loss (a
    0-d tensor on the model's device)."""
    opt.zero_grad()
    loss = loss_fn(model, batch, **loss_kw)
    loss.backward()
    opt.step()
    return loss.detach()
