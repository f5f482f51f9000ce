"""SGNS (skip-gram with negative sampling) — the paper's base model, in torch.

word2vec's SGNS objective (Eq. 1 of the paper):

    log σ(w·c) + Σ_{k} E_{c'~P_D^{3/4}} log σ(−w·c')

The counterpart of ``repro.core.sgns``: two step functions with the same
math — ``train_step_dense`` (autograd through the gathers, a dense
``(V, d)`` gradient; the oracle) and ``train_step_sparse`` (manual
per-row gradients and an accumulating scatter-add) — the linear learning
rate, and word2vec's initialization W ~ U(−0.5/d, 0.5/d), C = 0, drawn
through :mod:`repro_torch.prng` so that it is bitwise equal to the
reference's from the same key.

The update engines run the **worker-batched** forms
(:func:`train_step_dense_`, :func:`train_step_sparse_`): stacked
``(n, V, d)`` tables updated in place, ``(n, B)`` ids, worker w's ids
offset by ``w·V`` into the flattened ``(n·V, d)`` views, so one gather,
one row-gradient call and one scatter per table cover all n workers.
Workers touch disjoint rows, so each worker's result is its own
single-model step.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch import prng
from repro_torch.device import resolve_device
from repro_torch.spans import span


@dataclass(frozen=True)
class SGNSConfig:
    vocab_size: int
    dim: int = 500            # paper: 500 dims
    window: int = 10          # paper: 10 each side
    negatives: int = 5        # word2vec default k
    lr: float = 0.025         # word2vec default initial alpha
    lr_min: float = 1e-4
    seed: int = 0


def init_params(key, cfg: SGNSConfig, device=None) -> dict:
    """``{"W": U(−0.5/d, 0.5/d), "C": 0}`` of shape ``(V, d)`` from a
    ``(2,)`` uint32 key, on ``device`` (the GPU unless ``device="cpu"``)."""
    device = resolve_device(device)
    kw, _ = prng.split(key)
    w = prng.uniform(kw, (cfg.vocab_size, cfg.dim), -0.5 / cfg.dim,
                     0.5 / cfg.dim, device=device)
    c = torch.zeros((cfg.vocab_size, cfg.dim), dtype=torch.float32,
                    device=device)
    return {"W": w, "C": c}


def _pair_losses(w: torch.Tensor, c_pos: torch.Tensor,
                 c_neg: torch.Tensor) -> torch.Tensor:
    """Per-pair SGNS loss on gathered rows ``w, c_pos (..., d)``,
    ``c_neg (..., K, d)``, in the reference's log σ form."""
    s_pos = (w * c_pos).sum(-1)
    s_neg = torch.einsum("...d,...kd->...k", w, c_neg)
    return -F.logsigmoid(s_pos) - F.logsigmoid(-s_neg).sum(-1)


def negative_logits_loss(w: torch.Tensor, c_pos: torch.Tensor,
                         c_neg: torch.Tensor) -> torch.Tensor:
    """Mean SGNS loss for gathered rows w (B,d), c_pos (B,d), c_neg (B,K,d)."""
    return _pair_losses(w, c_pos, c_neg).mean()


def loss_fn(params: dict, centers: torch.Tensor, contexts: torch.Tensor,
            negatives: torch.Tensor) -> torch.Tensor:
    """Mean SGNS loss of a batch, through the gathers."""
    centers, contexts = centers.long(), contexts.long()
    return negative_logits_loss(params["W"][centers], params["C"][contexts],
                                params["C"][negatives.long()])


def sum_loss_fn(params: dict, centers: torch.Tensor, contexts: torch.Tensor,
                negatives: torch.Tensor) -> torch.Tensor:
    """Sum-over-pairs loss — word2vec's update semantics: each (w, c)
    pair applies its own lr·grad independently, so a minibatch applies
    the *sum* of per-pair gradients (not the mean)."""
    return loss_fn(params, centers, contexts, negatives) * centers.shape[0]


def sum_loss_grads(params: dict, centers: torch.Tensor, contexts: torch.Tensor,
                   negatives: torch.Tensor):
    """:func:`sum_loss_fn` and its gradient through the gathers: ``(sum
    loss, {"W", "C"})``, each gradient dense ``(V, d)``. The gathers'
    backward is ``index_put_(accumulate=True)``, which on the GPU adds
    duplicate rows in sorted serial order, so it repeats bit for bit."""
    leaves = {k: v.detach().requires_grad_() for k, v in params.items()}
    with torch.enable_grad():
        sum_loss = sum_loss_fn(leaves, centers, contexts, negatives)
        grads = torch.autograd.grad(sum_loss, [leaves["W"], leaves["C"]])
    return sum_loss.detach(), dict(zip(("W", "C"), grads))


def train_step_dense(params: dict, centers: torch.Tensor,
                     contexts: torch.Tensor, negatives: torch.Tensor,
                     lr: float):
    """Autograd step: the gradient of :func:`sum_loss_fn` through the
    gathers, a dense ``(V, d)`` gradient per table, ``p − lr·g`` over the
    whole table. Returns ``(new tables, mean loss)`` like the reference."""
    sum_loss, grads = sum_loss_grads(params, centers, contexts, negatives)
    lr32 = float(np.float32(lr))
    new = {k: params[k] - lr32 * g for k, g in grads.items()}
    return new, sum_loss / centers.shape[0]


def sparse_row_grads_per_pair(w: torch.Tensor, c_pos: torch.Tensor,
                              c_neg: torch.Tensor):
    """Per-pair losses and per-row gradients of the *sum* SGNS loss on
    gathered rows w (B,d), c_pos (B,d), c_neg (B,K,d).

    Returns (loss (B,), dW_rows (B,d), dC_pos_rows (B,d),
    dC_neg_rows (B,K,d)).
    """
    s_pos = (w * c_pos).sum(-1)
    s_neg = torch.einsum("bd,bkd->bk", w, c_neg)
    loss = -F.logsigmoid(s_pos) - F.logsigmoid(-s_neg).sum(-1)
    g_pos = torch.sigmoid(s_pos) - 1.0
    g_neg = torch.sigmoid(s_neg)
    d_w = g_pos[:, None] * c_pos + torch.einsum("bk,bkd->bd", g_neg, c_neg)
    d_cp = g_pos[:, None] * w
    d_cn = g_neg[..., None] * w[:, None, :]
    return loss, d_w, d_cp, d_cn


def sparse_row_grads(w, c_pos, c_neg):
    """(mean_loss, dW_rows, dC_pos_rows, dC_neg_rows)."""
    loss, d_w, d_cp, d_cn = sparse_row_grads_per_pair(w, c_pos, c_neg)
    return loss.mean(), d_w, d_cp, d_cn


def train_step_sparse(params: dict, centers: torch.Tensor,
                      contexts: torch.Tensor, negatives: torch.Tensor,
                      lr: float, row_grad_fn=sparse_row_grads):
    """Gather → row grads → accumulating scatter-add, in the reference's
    order (W at centers, then C at contexts, then C at negatives).
    Returns new tables, like the reference; duplicate ids accumulate."""
    centers, contexts = centers.long(), contexts.long()
    negatives = negatives.long()
    w = params["W"][centers]
    c_pos = params["C"][contexts]
    c_neg = params["C"][negatives]
    loss, d_w, d_cp, d_cn = row_grad_fn(w, c_pos, c_neg)
    neg_lr = -float(np.float32(lr))
    W = params["W"].index_add(0, centers, neg_lr * d_w)
    C = params["C"].index_add(0, contexts, neg_lr * d_cp)
    C = C.index_add_(0, negatives.reshape(-1),
                     neg_lr * d_cn.reshape(-1, d_cn.shape[-1]))
    return {"W": W, "C": C}, loss


# ---------------------------------------------------------------------------
# Worker-batched, in-place steps (what the update engines run)
# ---------------------------------------------------------------------------
def _flat(params: dict, centers: torch.Tensor, contexts: torch.Tensor,
          negatives: torch.Tensor):
    """``(n·V, d)`` views of the stacked tables and each worker's ids
    offset by ``w·V`` into them (int64, flattened)."""
    W, C = params["W"], params["C"]
    n, V, d = W.shape
    off = torch.arange(n, dtype=torch.int64, device=W.device) * V
    cen = (centers.long() + off[:, None]).reshape(-1)
    ctx = (contexts.long() + off[:, None]).reshape(-1)
    neg = (negatives.long() + off[:, None, None]).reshape(-1)
    return W.view(n * V, d), C.view(n * V, d), cen, ctx, neg


def train_step_sparse_(params: dict, centers: torch.Tensor,
                       contexts: torch.Tensor, negatives: torch.Tensor,
                       lr: float, row_grads=sparse_row_grads_per_pair):
    """:func:`train_step_sparse` for n workers at once, **in place**:
    params ``(n, V, d)``, centers/contexts ``(n, B)``, negatives
    ``(n, B, K)``. ``row_grads(w, c_pos, c_neg) -> (loss (N,), dW, dC_pos,
    dC_neg)`` on the ``N = n·B`` gathered pairs is the seam the
    row-gradient kernel plugs into. The scatter-adds run in the
    reference's order (W at centers, then C at contexts, then C at
    negatives); duplicate ids accumulate, each row's addends in pair
    order (:func:`ordered_add_`). Returns the per-pair loss ``(n, B)``."""
    n, B = centers.shape
    K = negatives.shape[-1]
    Wf, Cf, cen, ctx, neg = _flat(params, centers, contexts, negatives)
    d = Wf.shape[1]
    loss, d_w, d_cp, d_cn = row_grads(Wf[cen], Cf[ctx], Cf[neg].view(n * B, K, d))
    neg_lr = -float(np.float32(lr))
    ordered_add_(Wf, cen, neg_lr * d_w)
    ordered_add_(Cf, ctx, neg_lr * d_cp)
    ordered_add_(Cf, neg, neg_lr * d_cn.reshape(-1, d))
    return loss.view(n, B)


def ordered_add_(table: torch.Tensor, rows: torch.Tensor,
                 addends: torch.Tensor) -> torch.Tensor:
    """``table[rows[i]] += addends[i]`` for i in order, **in place**: each
    row's duplicates are added one by one in the order they come, so the
    same inputs give the same bits on every run and on either device. On
    the CPU that is ``index_add_``'s serial loop. On the GPU
    ``index_add_`` adds duplicates with float atomics in no fixed order;
    ``index_put_(accumulate=True)`` sorts the ids stably and adds each run
    of duplicates serially, in the same order and rounding as the CPU
    loop (no float atomics, no global determinism flag)."""
    if table.device.type == "cpu":
        return table.index_add_(0, rows, addends)
    return table.index_put_((rows,), addends, accumulate=True)


def train_step_dense_(params: dict, centers: torch.Tensor,
                      contexts: torch.Tensor, negatives: torch.Tensor,
                      lr: float) -> torch.Tensor:
    """:func:`train_step_dense` for n workers at once, **in place**: the
    gradient of every worker's sum loss through the gathers (dense over
    the ``(n·V, d)`` tables), then ``p − lr·g``. Returns the per-pair loss
    ``(n, B)``. The gathers' backward is ``index_put_(accumulate=True)``,
    which on the GPU adds duplicate rows in sorted serial order, so the
    step repeats bit for bit there too."""
    n, B = centers.shape
    Wf, Cf, cen, ctx, neg = _flat(params, centers, contexts, negatives)
    d = Wf.shape[1]
    Wl, Cl = Wf.detach().requires_grad_(), Cf.detach().requires_grad_()
    with torch.enable_grad():
        loss = _pair_losses(Wl[cen], Cl[ctx], Cl[neg].view(n * B, -1, d))
        gW, gC = torch.autograd.grad(loss.sum(), [Wl, Cl])
    lr32 = float(np.float32(lr))
    Wf.sub_(lr32 * gW)
    Cf.sub_(lr32 * gC)
    return loss.detach().view(n, B)


def worker_mean(loss: torch.Tensor) -> torch.Tensor:
    """Each worker's mean over its ``B`` pair losses, ``(n, B) -> (n,)``, in
    one fixed order whatever ``n``: a pairwise tree of elementwise adds
    (zero-padded to a power of two), then a division by ``B``. A reduction
    such as ``loss.mean(dim=1)`` on the card splits each row over more or
    fewer threads as ``n`` changes, so a worker's loss would depend on how
    many workers share the launch; this does not, so a worker's chunk
    losses are bitwise the same when its process trains a block of the
    workers (multi-process training) or one alone (elastic)."""
    with span("repro_torch.step.loss"):
        B = loss.shape[1]
        x = loss
        width = 1 << max(B - 1, 0).bit_length()
        if width != B:
            x = F.pad(x, (0, width - B))
        while x.shape[1] > 1:
            h = x.shape[1] // 2
            x = x[:, :h] + x[:, h:]
        return x[:, 0] / B


def linear_lr(step: int, total_steps: int, cfg: SGNSConfig) -> np.float32:
    """word2vec's linearly decaying alpha, in float32 with the
    reference's expression: ``max(lr·(1 − clip(step/total, 0, 1)), lr_min)``."""
    f32 = np.float32
    frac = np.clip(f32(step) / f32(max(total_steps, 1)), f32(0.0), f32(1.0))
    return np.maximum(f32(cfg.lr) * (f32(1.0) - frac), f32(cfg.lr_min))


def embedding_matrix(params: dict) -> torch.Tensor:
    """The word representation the paper evaluates (input vectors W)."""
    return params["W"]
