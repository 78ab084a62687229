"""Training steps for the encoders, the port of stract_tpu/parallel/train.py
(the cross encoder's pairwise step, plain and distilled) plus the dual
encoder's InfoNCE loss of stract_tpu/entrypoint/train_encoders.py:246-251.

The JAX package runs these as pjit programs over a (dp, tp, sp, ep) mesh.
The port trains on one card: the mesh and its sharding arguments are gone,
and the orbax train-state checkpoints (parallel/train.py:127-149) are not
ported; trained models are saved as serving checkpoints by the entry points.
`make_train_state(num_experts=E)` builds the cross encoder with the MoE FFN
(models/bert.py MoEMlp) in every layer, as the JAX package does: its
expert weights are bf16 parameters, and AdamW updates them in bf16 with bf16
moments (optim.py, K15d) beside the f32 masters of the dense weights.

A step: the forward of both sides of the batch through the encoder in its
training form (f32 masters cast per call; K5a-d, and K15a-b with experts),
the loss head (ops/losses.py, K15c: the pairwise softplus, the MSE to the
teacher, the B x B InfoNCE cross-entropy, value and gradient in one pass),
autograd back through K14a-c, K15a-b and the cuBLAS products, then the fused
AdamW update (optim.py, K14d and K15d).
"""

from __future__ import annotations

import torch

from ..models.bert import BertConfig, BertForSequenceScore, random_init
from ..ops import losses
from ..optim import AdamW


def ranking_loss(scores_pos, scores_neg):
    """Pairwise logistic loss: -log σ(s+ − s−) = softplus(s− − s+), mean."""
    return losses.pair_loss(scores_pos, scores_neg)


def make_train_state(cfg: BertConfig, learning_rate: float = 1e-4, seed: int = 0,
                     num_experts: int = 0, device="cuda"):
    """A cross encoder in its training form (random init from `seed`) on
    `device`, with `num_experts` MoE experts per layer (0: dense FFNs), and
    its optimizer → (model, opt)."""
    model = random_init(BertForSequenceScore(cfg, param_dtype=torch.float32,
                                             num_experts=num_experts), seed).to(device)
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
    return losses.pair_loss(s_pos, s_neg, batch["t_pos"], batch["t_neg"], alpha)


def info_nce_loss(model, batch, temperature: float = 20.0):
    """The dual encoder's in-batch-negative loss: cross-entropy of the B x B
    similarity of L2-normalised query and doc embeddings, times
    `temperature`, against the diagonal. batch: q_ids / q_mask / d_ids /
    d_mask int32[B, T]."""
    qe = model(batch["q_ids"], batch["q_mask"])
    de = model(batch["d_ids"], batch["d_mask"])
    return losses.info_nce((qe @ de.T) * temperature)


def train_step(model, opt: AdamW, batch, loss_fn=pairwise_loss, **loss_kw) -> torch.Tensor:
    """One step: zero the gradients, loss, backward, AdamW → the loss (a
    0-d tensor on the model's device)."""
    opt.zero_grad()
    loss = loss_fn(model, batch, **loss_kw)
    loss.backward()
    opt.step()
    return loss.detach()
