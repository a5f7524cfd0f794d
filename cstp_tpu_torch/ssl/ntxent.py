"""NT-Xent (SimCLR) contrastive loss with in-batch negatives.

The port of ``cstp_tpu/ssl/ntxent.py`` (reference ``loss/NTXent.py``:
cosine similarity, temperature, self-pairs masked). Plain PyTorch: the JAX
package has no kernel for it.

Under data parallelism the negatives are the global batch's:
:func:`cross_replica_ntxent` gathers every rank's projections first, so
each rank computes the loss of the global batch, as the JAX step does on a
'data'-sharded batch. The gather's backward sums the ranks' gradients of
this rank's rows, which the gradient average then divides back.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from cstp_tpu_torch.models.layers import l2_normalize
from cstp_tpu_torch.parallel.mesh import all_gather_rows


def ntxent_loss(zi: torch.Tensor, zj: torch.Tensor,
                temperature: float = 0.5) -> torch.Tensor:
    """Mean NT-Xent over the 2B rows of ``[zi; zj]`` (``(B, D)`` each), in
    float32: row r's positive is row ``(r + B) mod 2B``, its own similarity
    is masked, and the rest of the row are its negatives."""
    b = zi.shape[0]
    z = l2_normalize(torch.cat([zi, zj], dim=0).float())
    sim = z @ z.T / temperature
    eye = torch.eye(2 * b, dtype=torch.bool, device=z.device)
    sim = sim.masked_fill(eye, float("-inf"))
    pos = (torch.arange(2 * b, device=z.device) + b) % (2 * b)
    logp = F.log_softmax(sim, dim=-1)
    return -logp.gather(1, pos[:, None])[:, 0].mean()


def cross_replica_ntxent(zi: torch.Tensor, zj: torch.Tensor,
                         temperature: float = 0.5) -> torch.Tensor:
    """NT-Xent over the global batch: each rank's ``(b, D)`` projections
    gathered in rank order (the plain loss without a process group)."""
    return ntxent_loss(all_gather_rows(zi), all_gather_rows(zj), temperature)
