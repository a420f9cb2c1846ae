"""Vector quantization with an EMA codebook (``frankenstein_tpu/ops/vq.py``).

The reference configures ``vector_quantize_pytorch.VectorQuantize`` with
``commitment_weight=0.25, kmeans_init=True, threshold_ema_dead_code=2,
use_cosine_sim=True``; the JAX package writes its own, and this is its port:

- nearest code by cosine similarity (or euclidean distance), one product
  and an argmax;
- a straight-through estimator for the encoder's gradient and a
  commitment loss against the frozen codes;
- an EMA update of the codebook from the batch (train mode);
- k-means initialisation from the first train batch (a fixed number of
  Lloyd steps) while ``initted`` is 0;
- dead-code refresh: codes whose EMA cluster size falls below the threshold
  are re-seeded with (normalised) rows of the batch.

The state is buffers, under the names the JAX package's
``export_soundstream`` writes (vector_quantize_pytorch's):
``_codebook.embed`` [K, D], ``_codebook.cluster_size`` [K],
``_codebook.embed_avg`` [K, D] (kept equal to ``embed * cluster_size``)
and ``_codebook.initted`` [1]. Lookup, loss and update run in f32, and the
update writes the buffers in place under ``torch.no_grad()`` after the
forward has read them.

The draws (k-means' initial means, the refresh's rows) come from the
``generator`` the caller passes, not from the JAX package's ``"vq"``
stream, so the two frameworks draw different rows; ``_kmeans`` and
``_refresh`` take their indices as arguments so a test can give both the
same. With ``threshold_ema_dead_code <= 0`` no code can be dead and the
refresh draws nothing.

Under ``parallel/mesh.py:batch_shard`` (data parallelism) a rank holds its
share of the global batch and the quantizer computes what one device
computes on the whole of it, as the JAX package's global batch does under
``jit``: the EMA's counts and sums are summed over the data group
(``mesh.global_sum``), k-means runs on the gathered global rows
(``mesh.global_cat``) and the refresh takes its rows from them, both with
k indices in [0, N_global) drawn alike on every rank (the trainer seeds
every rank's generator the same), and the perplexity counts the global
batch's codes. The new buffers are broadcast from the group's first rank,
so every rank ends a step with the same codebook bitwise. The commitment
loss stays this rank's mean, whose mean over the group (DDP's and FSDP's
gradient average, the trainer's logged mean) is the global one.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from frankenstein_tpu_torch.config import VQVAEConfig
from frankenstein_tpu_torch.parallel import mesh as mesh_lib

KMEANS_ITERS = 10     # Lloyd steps of the k-means initialisation


def l2norm(x: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    return x * torch.rsqrt(torch.sum(x * x, dim=-1, keepdim=True) + eps)


def _assign(samples: torch.Tensor, ref: torch.Tensor,
            cosine: bool) -> torch.Tensor:
    """The nearest row of ``ref`` [K, D] for each of ``samples`` [N, D]."""
    if cosine:
        return torch.argmax(l2norm(samples) @ l2norm(ref).T, dim=-1)
    dist = (torch.sum(samples * samples, -1, keepdim=True)
            - 2 * samples @ ref.T + torch.sum(ref * ref, -1))
    return torch.argmin(dist, dim=-1)


def _counts_sums(assign: torch.Tensor, samples: torch.Tensor, k: int):
    """(rows a code [K], their sum [K, D]), by a one-hot product as in the
    JAX package (deterministic on the card, unlike ``index_add_``)."""
    onehot = F.one_hot(assign, k).to(samples.dtype)
    return onehot.sum(0), onehot.T @ samples


def _kmeans(samples: torch.Tensor, k: int, iters: int, cosine: bool,
            init_idx: torch.Tensor):
    """Fixed-iteration Lloyd from the means ``samples[init_idx]``:
    samples [N, D] -> (means [K, D], counts [K]). An empty cluster keeps its
    mean."""
    means = samples[init_idx]
    for _ in range(iters):
        counts, sums = _counts_sums(_assign(samples, means, cosine),
                                    samples, k)
        new = sums / torch.clamp_min(counts[:, None], 1.0)
        means = torch.where(counts[:, None] > 0, new, means)
    counts, _ = _counts_sums(_assign(samples, means, cosine), samples, k)
    return means, counts


def _ema_update(cb: torch.Tensor, cs: torch.Tensor, samples: torch.Tensor,
                assign: torch.Tensor, decay: float, cosine: bool):
    """One EMA step of codebook ``cb`` [K, D] and cluster sizes ``cs`` [K]
    towards the mean (normalised, cosine) of the rows each code took, the
    counts and sums the global batch's under ``mesh.batch_shard``."""
    counts, sums = _counts_sums(assign, samples, cb.shape[0])
    counts, sums = mesh_lib.global_sum(counts), mesh_lib.global_sum(sums)
    new_cs = cs * decay + counts * (1 - decay)
    mean = sums / torch.clamp_min(counts[:, None], 1.0)
    upd = torch.where(counts[:, None] > 0, l2norm(mean) if cosine else mean,
                      cb)
    return cb * decay + upd * (1 - decay), new_cs


def _refresh(cb: torch.Tensor, cs: torch.Tensor, samples: torch.Tensor,
             sample_idx: torch.Tensor, threshold: float, cosine: bool):
    """Codes whose cluster size is under ``threshold`` take the row
    ``samples[sample_idx[code]]`` (normalised, cosine) and size 1."""
    dead = cs < threshold
    repl = samples[sample_idx]
    if cosine:
        repl = l2norm(repl)
    return (torch.where(dead[:, None], repl, cb),
            torch.where(dead, torch.ones_like(cs), cs))


def codebook_perplexity(indices: torch.Tensor,
                        codebook_size: int) -> torch.Tensor:
    """exp(entropy) of the codes' empirical use (the global batch's under
    ``mesh.batch_shard``)."""
    shard = mesh_lib.current_batch_shard()
    counts = mesh_lib.global_sum(torch.bincount(indices.reshape(-1),
                                                minlength=codebook_size))
    avg = counts.to(torch.float32) / (indices.numel()
                                      * (shard.size if shard else 1))
    return torch.exp(-torch.sum(avg * torch.log(avg + 1e-10)))


class _Codebook(nn.Module):
    """The quantizer's state, as vector_quantize_pytorch names it."""

    def __init__(self, k: int, d: int, kmeans_init: bool, device=None):
        super().__init__()
        f32 = dict(dtype=torch.float32, device=device)
        self.register_buffer("embed", torch.zeros(k, d, **f32))
        self.register_buffer("cluster_size", torch.ones(k, **f32))
        self.register_buffer("embed_avg", torch.zeros(k, d, **f32))
        self.register_buffer("initted", torch.full(
            (1,), 0.0 if kmeans_init else 1.0, **f32))


class VectorQuantize(nn.Module):
    """``forward(x [..., D], train=..., generator=...)`` -> (quantized
    [..., D] in x's dtype, indices [...] int64, commitment loss f32)."""

    def __init__(self, cfg: VQVAEConfig, device=None):
        super().__init__()
        self.cfg = cfg
        self._codebook = _Codebook(cfg.codebook_size, cfg.D, cfg.kmeans_init,
                                   device)

    def initted(self) -> bool:
        return bool(self._codebook.initted.item())

    def forward(self, x: torch.Tensor, *, train: bool = False,
                generator: Optional[torch.Generator] = None):
        c = self.cfg
        k, cosine = c.codebook_size, c.use_cosine_sim
        book = self._codebook
        flat = x.reshape(-1, c.D).to(torch.float32)
        shard = mesh_lib.current_batch_shard()
        n = flat.shape[0] * (shard.size if shard else 1)   # global rows

        def draw():
            return torch.randint(0, n, (k,), generator=generator,
                                 device=flat.device)

        with torch.no_grad():
            data = flat.detach()
            if train and not self.initted():
                cb, cs = _kmeans(mesh_lib.global_cat(data), k, KMEANS_ITERS,
                                 cosine, draw())
            else:
                cb, cs = book.embed.float(), book.cluster_size.float()
            indices = _assign(data, cb, cosine)
            quantized = (l2norm(cb) if cosine else cb)[indices]

        # commitment: pull the encoder's output toward the frozen codes
        commit_loss = c.commitment_weight * torch.mean(
            torch.square(flat - quantized))
        quantized_st = flat + (quantized - flat).detach()

        if train:
            with torch.no_grad():
                new_cb, new_cs = _ema_update(cb, cs, data, indices,
                                             c.ema_decay, cosine)
                if c.threshold_ema_dead_code > 0:
                    new_cb, new_cs = _refresh(
                        new_cb, new_cs, mesh_lib.global_cat(data), draw(),
                        c.threshold_ema_dead_code, cosine)
                if shard is not None:
                    mesh_lib.replicate([new_cb, new_cs], shard.group)
                book.embed.copy_(new_cb)
                book.cluster_size.copy_(new_cs)
                book.embed_avg.copy_(new_cb * new_cs[:, None])
                book.initted.fill_(1.0)

        return (quantized_st.reshape(x.shape).to(x.dtype),
                indices.reshape(x.shape[:-1]), commit_loss)
