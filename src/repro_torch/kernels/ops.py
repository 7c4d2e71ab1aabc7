"""Dispatch between the Hopper kernels and their plain versions.

Counterpart of ``src/repro/kernels/ops.py``.  The device of the input
decides, and nothing else: a CUDA tensor launches the hand-written kernel
(a build or launch failure raises — there is no fallback), a CPU tensor
takes the plain PyTorch version.  There is no ``mode=`` switch; code that
wants the plain version on the card (the kernel checks in
``chip_smoke.py``) calls ``*_plain`` directly.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.packing import BSRPlanes, BSRWeight
from .block_sparse_matmul import (
    bsr_matmul_cuda,
    bsr_matmul_plain,
    bsr_planes_matmul_cuda,
    bsr_planes_matmul_plain,
)
from .epilogue import Epilogue
from .paged_attention import (
    paged_attention_decode_cuda,
    paged_attention_decode_plain,
    paged_attention_prefill_cuda,
    paged_attention_prefill_plain,
)
from .structure_norms import structure_norms_cuda, structure_norms_plain

__all__ = ["bsr_matmul", "bsr_planes_matmul", "paged_attention_decode",
           "paged_attention_prefill", "structure_norms"]


def _on_card(t: torch.Tensor) -> bool:
    if t.is_cuda:
        return True
    if t.device.type != "cpu":
        raise ValueError(f"no kernel or plain version for device {t.device}")
    return False


def bsr_matmul(x: torch.Tensor, bsr: BSRWeight, *,
               epilogue: Optional[Epilogue] = None) -> torch.Tensor:
    """y = epilogue(x @ W_bsr) for x (..., K), in x's dtype;
    multiplier/residual are shaped like the output (..., N).  bf16 x
    under fp32 weights is contracted in fp32."""
    lead = x.shape[:-1]
    k = x.shape[-1]
    x2 = x.reshape(-1, k)
    epi = None if epilogue is None else epilogue.map_operands(
        lambda a: a.reshape(-1, a.shape[-1]))
    if _on_card(x2):
        # the kernel takes x in the weight's dtype; fp32 weights under
        # bf16 activations (whisper-tiny's config) are contracted in fp32,
        # as the reference's jnp.dot promotes them: x widens exactly
        wide = bsr.blocks.dtype
        if x2.dtype == torch.bfloat16 and wide == torch.float32:
            x2 = x2.to(wide)
        if epi is not None:
            epi = epi.map_operands(lambda a: a.to(x2.dtype).contiguous())
        y = bsr_matmul_cuda(x2.contiguous(), bsr, epilogue=epi).to(x.dtype)
    else:
        y = bsr_matmul_plain(x2, bsr, epilogue=epi)
    return y.reshape(*lead, bsr.shape[1])


def bsr_planes_matmul(x: torch.Tensor, planes: BSRPlanes, *,
                      epilogue: Optional[Epilogue] = None,
                      row_counts: Optional[torch.Tensor] = None) -> torch.Tensor:
    """y[e] = epilogue(x[e] @ W_bsr[e]) for x (E, ..., K), every plane in
    one call; multiplier/residual are shaped (E, ..., N) like the output,
    the bias (N,) is shared by the planes.  ``row_counts`` (E, S): the
    rows of a plane, flattened, are S equal segments whose rows at or past
    the segment's count are taken as zero rows (see
    ``block_sparse_matmul``); None: every row is live."""
    e = x.shape[0]
    lead = x.shape[1:-1]
    x3 = x.reshape(e, -1, x.shape[-1])
    epi = None if epilogue is None else epilogue.map_operands(
        lambda a: a.reshape(e, -1, a.shape[-1]))
    if _on_card(x3):
        if epi is not None:
            epi = epi.map_operands(lambda a: a.contiguous())
        y = bsr_planes_matmul_cuda(x3.contiguous(), planes, epilogue=epi,
                                   row_counts=row_counts)
    else:
        y = bsr_planes_matmul_plain(x3, planes, epilogue=epi,
                                    row_counts=row_counts)
    return y.reshape(e, *lead, planes.shape[-1])


def paged_attention_decode(q, k_new, v_new, k_pool, v_pool, page_table,
                           cache_len) -> torch.Tensor:
    """Paged decode attention over [0, cache_len) plus the new token.
    Returns (B, H, dh) fp32."""
    if _on_card(q):
        clen = torch.as_tensor(cache_len, device=q.device).reshape(-1)
        clen = clen.expand(q.shape[0]).to(torch.int32).contiguous()
        return paged_attention_decode_cuda(
            q, k_new, v_new, k_pool, v_pool,
            page_table.to(torch.int32).contiguous(), clen)
    return paged_attention_decode_plain(
        q, k_new, v_new, k_pool, v_pool, page_table, cache_len)


def paged_attention_prefill(q, k_pool, v_pool, page_table, lengths, *,
                            q_offset: int = 0) -> torch.Tensor:
    """Causal paged prefill attention for queries at
    [q_offset, q_offset+S).  Returns (B, S, H, dh) fp32."""
    if _on_card(q):
        ln = torch.as_tensor(lengths, device=q.device).reshape(-1)
        ln = ln.expand(q.shape[0]).to(torch.int32).contiguous()
        return paged_attention_prefill_cuda(
            q, k_pool, v_pool, page_table.to(torch.int32).contiguous(), ln,
            q_offset=q_offset)
    return paged_attention_prefill_plain(
        q, k_pool, v_pool, page_table, lengths, q_offset=q_offset)


def structure_norms(w: torch.Tensor, bk: int = 128, bn: int = 128) -> torch.Tensor:
    """Tile L2 norms (grid_k, grid_n) fp32 of a (K, N) weight."""
    if _on_card(w):
        return structure_norms_cuda(w, bk, bn)
    return structure_norms_plain(w, bk, bn)
