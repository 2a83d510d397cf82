"""Public wrapper for the flash attention kernels, forward and backward.

``flash_attention(q, k, v, *, scale, causal, window, attn_softcap,
q_offset)`` takes q (B, Sq, H, hd) and k/v (B, T, KV, hd) and returns
(B, Sq, H, hd) in q's dtype.

* On CPU tensors it runs the plain versions (``ref.py``).
* On CUDA tensors it checks dtype (float32 or bfloat16, the same for all
  three), shapes (hd in 32/64/128/256, H a multiple of KV), contiguity and
  16-byte alignment, then launches the CUDA kernel or raises. Nothing
  falls back.

Where autograd records (grad enabled and q, k or v requiring a gradient)
the call goes through ``_FlashAttention``, an ``autograd.Function`` (the
reference wraps its kernel in ``jax.custom_vjp``, ``ops.py:25-46``): its
forward launches the forward kernel with the per-row log-sum-exp output
and saves q, k, v, out and lse; its backward runs ``_FlashAttentionBwd``,
which launches the backward kernel. Each direction has a float32 kernel
(``csrc/flash_attention.cu``, ``csrc/flash_attention_bwd.cu``) and a
bfloat16 one on the bf16 tensor cores (``csrc/flash_attention_fwd_bf16.cu``,
``csrc/flash_attention_bwd_bf16.cu``: float32 arithmetic, the outputs
rounded to bfloat16 at the end, as the reference's kernel and ``_bwd``),
picked by the inputs' dtype. On CPU tensors both
directions run the plain versions (``flash_attention_fwd_plain``,
``flash_attention_bwd_plain``). Otherwise
``_FlashAttentionFwd`` launches the forward kernel with no lse.

The three functions work under ``torch.func``: each has a ``vmap`` rule
that folds the vmapped runs into the kernel's batch axis (an unbatched
input broadcast to every run) and makes one call, so
``vmap(grad(loss))`` over R runs launches each kernel once, where the
reference ``vmap``s its kernel (``repro/fitness/lm.py:106``).

``launches`` counts the forward kernel's launches of this process and
``bwd_launches`` the backward's; each grows only where its kernel is
launched, once per folded call.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.attention.flash import (flash_attention_bwd_cuda,
                                                 flash_attention_fwd_cuda)
from repro_torch.kernels.attention.ref import (flash_attention_blocked,
                                               flash_attention_bwd_plain,
                                               flash_attention_fwd_plain)

launches = 0
bwd_launches = 0

HEAD_DIMS = (32, 64, 128, 256)
#: what the kernels take, forward and backward
DTYPES = (torch.float32, torch.bfloat16)


#: The plain PyTorch version, on any device: what the wrapper runs on the
#: CPU, and what the kernel is held against on the card.
flash_attention_plain = flash_attention_blocked


def _check(q, k, v):
    if q.ndim != 4 or k.ndim != 4 or tuple(k.shape) != tuple(v.shape):
        raise ValueError(f"flash_attention: q {tuple(q.shape)} must be "
                         f"(B, Sq, H, hd) and k/v {tuple(k.shape)}, "
                         f"{tuple(v.shape)} both (B, T, KV, hd)")
    b, _, h, hd = q.shape
    if k.shape[0] != b or k.shape[3] != hd or h % k.shape[2]:
        raise ValueError(f"flash_attention: shapes q {tuple(q.shape)} and "
                         f"k {tuple(k.shape)} do not match (same B and hd, "
                         f"H a multiple of KV)")
    if hd not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head dim {hd} not in "
                         f"{HEAD_DIMS}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device != q.device or t.dtype != q.dtype or \
                t.dtype not in DTYPES:
            raise ValueError(f"flash_attention: {name} is {t.dtype} on "
                             f"{t.device}; the kernel takes float32 or "
                             f"bfloat16, the same for q, k, v, on "
                             f"{q.device}")
        _check_layout(name, t)


def _check_layout(name, t):
    if not t.is_contiguous():
        raise ValueError(f"flash_attention: {name} is not contiguous")
    if t.data_ptr() % 16:
        raise ValueError(f"flash_attention: {name} is not 16-byte "
                         f"aligned (the kernel copies 16-byte rows)")


def _on_cuda(q):
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"flash_attention runs on cuda or cpu tensors, "
                         f"not {q.device}")
    return q.device.type == "cuda"


def _kw(scale, causal, window, attn_softcap, q_offset) -> dict:
    return dict(scale=scale, causal=causal, window=window,
                attn_softcap=attn_softcap, q_offset=q_offset)


def _fold(info, in_dims, tensors):
    """The vmap rules' layout: each tensor's vmapped dim moved to the
    front (an unbatched tensor broadcast to the ``info.batch_size`` runs),
    then runs x batch folded into the kernel's batch axis as one contiguous
    tensor, which ``_check_layout`` takes."""
    r, out = info.batch_size, []
    for t, d in zip(tensors, in_dims):
        t = t.expand(r, *t.shape) if d is None else t.movedim(d, 0)
        out.append(t.reshape(r * t.shape[1], *t.shape[2:]).contiguous())
    return out


def _unfold(r, tensors):
    """The folded batch axis split back into (runs, batch)."""
    return tuple(t.reshape(r, -1, *t.shape[1:]) for t in tensors)


class _FlashAttention(torch.autograd.Function):
    """Flash attention with the backward kernel as its gradient: returns
    (out, lse), lse not differentiable. Under ``torch.func.vmap`` its rule
    folds the runs into the batch axis, so a vmapped call is one launch;
    its backward goes through ``_FlashAttentionBwd``, which folds the same
    way under ``vmap(grad(...))``."""

    @staticmethod
    def forward(q, k, v, scale, causal, window, attn_softcap, q_offset):
        global launches
        kw = _kw(scale, causal, window, attn_softcap, q_offset)
        if _on_cuda(q):
            _check(q, k, v)
            out, lse = flash_attention_fwd_cuda(q, k, v, with_lse=True, **kw)
            launches += 1
            return out, lse
        return flash_attention_fwd_plain(q, k, v, **kw)

    @staticmethod
    def setup_context(ctx, inputs, output):
        q, k, v, *args = inputs
        out, lse = output
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.mark_non_differentiable(lse)
        ctx.args = args

    @staticmethod
    def backward(ctx, dout, _dlse):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = _FlashAttentionBwd.apply(q, k, v, out, lse, dout,
                                              *ctx.args)
        return dq, dk, dv, None, None, None, None, None

    @staticmethod
    def vmap(info, in_dims, q, k, v, *args):
        out = _FlashAttention.apply(*_fold(info, in_dims[:3], (q, k, v)),
                                    *args)
        return _unfold(info.batch_size, out), (0, 0)


class _FlashAttentionBwd(torch.autograd.Function):
    """The backward kernel, (q, k, v, out, lse, dout) -> (dq, dk, dv), as a
    function that ``torch.func`` can batch: ``grad`` inside ``vmap`` runs
    the backward on batched tensors, and the rule folds them as
    ``_FlashAttention``'s does. It has no derivative of its own."""

    @staticmethod
    def forward(q, k, v, out, lse, dout, scale, causal, window, attn_softcap,
                q_offset):
        global bwd_launches
        kw = _kw(scale, causal, window, attn_softcap, q_offset)
        dout = dout.contiguous()
        if not _on_cuda(q):
            return flash_attention_bwd_plain(q, k, v, out, lse, dout, **kw)
        if dout.dtype != q.dtype:
            raise ValueError(f"flash_attention: the output gradient is "
                             f"{dout.dtype}, the kernel takes {q.dtype}")
        _check_layout("the output gradient", dout)
        grads = flash_attention_bwd_cuda(q, k, v, out, lse, dout, **kw)
        bwd_launches += 1
        return grads

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def backward(ctx, *grads):
        raise NotImplementedError("flash_attention has no second derivative "
                                  "(the backward kernel has no backward)")

    @staticmethod
    def vmap(info, in_dims, q, k, v, out, lse, dout, *args):
        grads = _FlashAttentionBwd.apply(
            *_fold(info, in_dims[:6], (q, k, v, out, lse, dout)), *args)
        return _unfold(info.batch_size, grads), (0, 0, 0)


class _FlashAttentionFwd(torch.autograd.Function):
    """The forward kernel without lse, where autograd does not record; a
    function only so that a vmapped evaluation folds into one launch."""

    @staticmethod
    def forward(q, k, v, scale, causal, window, attn_softcap, q_offset):
        global launches
        kw = _kw(scale, causal, window, attn_softcap, q_offset)
        if not _on_cuda(q):
            return flash_attention_plain(q, k, v, **kw)
        _check(q, k, v)
        out = flash_attention_fwd_cuda(q, k, v, **kw)
        launches += 1
        return out

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def backward(ctx, dout):
        raise NotImplementedError("flash_attention: the lse-free forward "
                                  "runs only where autograd does not "
                                  "record")

    @staticmethod
    def vmap(info, in_dims, q, k, v, *args):
        out = _FlashAttentionFwd.apply(*_fold(info, in_dims[:3], (q, k, v)),
                                       *args)
        return _unfold(info.batch_size, (out,))[0], 0


def flash_attention(q, k, v, *, scale, causal=True, window=0,
                    attn_softcap=0.0, q_offset=0):
    args = (scale, causal, window, attn_softcap, q_offset)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return _FlashAttention.apply(q, k, v, *args)[0]
    return _FlashAttentionFwd.apply(q, k, v, *args)
