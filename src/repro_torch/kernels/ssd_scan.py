"""The SSD scan of Mamba-2 (state-space duality, arXiv:2405.21060): its
hand-written kernels under autograd, and beside them the plain PyTorch
version and the plain twin of the kernels' backward.

Counterpart of the chunked scan inside ``repro.models.mamba2`` (no
Pallas kernel there: JAX computes it in plain ``jnp``).  The operands are
those of ``repro_torch.models.mamba2._ssd``: xh (b, L, h, P), B and C
(b, L, N) shared by every head or (b, L, G, N) in G groups (Mamba-2's
``ngroups``: head h reads group h // (h_total / G), and G divides the
heads), the step sizes dt and the log-decays l_t (b, L, h), ``Dp``
(h, 1), the carried state (b, h, P, N) in float32, and the chunk length
``Q``, which divides L.  It returns y (b, L, h, P) in float32 and the
final state.

:func:`ssd_scan` takes one of two routes, chosen by :func:`route` from
the operands alone:

- ``"kernel"`` (``csrc/ssd_scan.cu``): CUDA tensors in float32 or
  bfloat16, P up to :data:`MAX_HEADDIM` and Q up to :data:`MAX_CHUNK`.
  :class:`SSDScanFn` launches the forward kernels (S = C·Bᵀ once per row,
  chunk and group, the chunk states, the state passing, the chunk output)
  and,
  in its backward, the backward kernels; no (b, Q, Q, h) tensor reaches
  device memory.  Every product is fp32 on the CUDA cores; S is rounded
  to the operands' type as the plain version's einsum rounds it.  The
  backward keeps dS = ∂/∂S and the state parts of dB and dC in fp32 where
  the plain version's autograd rounds them to bf16, and sums over heads
  in a fixed order: two runs give the same bits.  A shape or type the
  kernels do not take raises; nothing falls back.
- ``"plain"`` (:func:`plain`): every other device (the CPU) and float64,
  the chunk loop in PyTorch under autograd, bit for bit what the port
  has always computed there.

:func:`ssd_backward` writes the kernels' backward formulas out in
PyTorch (the CPU twin that the tests hold against autograd through
:func:`plain`).  ``ssd_scan.launches`` counts the kernels' forwards,
``ssd_scan.launches_by_route`` the forwards on each route and
``ssd_scan.backward_calls_by_route`` the backwards, each once it has
run: :func:`forward` and :func:`backward` count after their launches
succeed, so a refused call counts nothing.  The kernel route's forward
and backward are the spans ``kernel.ssd_fwd`` and ``kernel.ssd_bwd``
(:mod:`repro_torch.obs`).
"""
from __future__ import annotations

import ctypes

import torch

from .. import obs
from . import _build

SOURCE = "ssd_scan"
ROUTES = ("kernel", "plain")
#: the longest chunk the kernels take (its decays sit in shared memory)
#: and the largest head dim (one 64-wide tile of P): :func:`_check`
#: refuses the rest before the library's own check would
MAX_CHUNK = 256
MAX_HEADDIM = 64
#: the kernels' dtype codes (x, B and C)
DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def heads_of_groups(h: int, G: int, device=None) -> torch.Tensor:
    """The group each of ``h`` heads reads: h // (h / G), G dividing h."""
    if G <= 0 or h % G:
        raise ValueError(f"ssd_scan: {G} groups do not split {h} heads")
    return torch.arange(h, device=device) // (h // G)


def plain(xh, B, C, dt, l_t, Dp, state, Q: int):
    """The chunked SSD scan: xh (b, L, h, P), B and C (b, L, N) or, in
    groups, (b, L, G, N), dt and the log-decays l_t (b, L, h), ``Dp``
    (h, 1), the carried state (b, h, P, N) in float32.  Within a chunk of
    ``Q`` the dual quadratic form, across chunks the recurrence.  Returns
    y (b, L, h, P) in float32 and the final state.  Float64 operands stay
    float64 (the sharded scan is held to this one there); narrower ones
    compute in float32: every product's operands are cast to that
    type."""
    if B.dim() == 4:
        return _plain_groups(xh, B, C, dt, l_t, Dp, state, Q)
    wide = torch.promote_types(xh.dtype, torch.float32)
    b, L, h, P = xh.shape
    N = B.shape[-1]
    nc = L // Q
    xc = xh.reshape(b, nc, Q, h, P)
    Bc = B.reshape(b, nc, Q, N)
    Cc = C.reshape(b, nc, Q, N)
    dtc = dt.reshape(b, nc, Q, h)
    Lcum = l_t.reshape(b, nc, Q, h).cumsum(dim=2)                # (b,nc,Q,h)
    mask = torch.tril(torch.ones(Q, Q, dtype=torch.bool, device=xh.device))
    ys = []
    for c in range(nc):
        xq, Bq, Cq = xc[:, c], Bc[:, c], Cc[:, c]
        dtq, Lq = dtc[:, c], Lcum[:, c]
        scores = torch.einsum("bln,bmn->blm", Cq, Bq).to(wide)
        gamma = torch.exp(torch.clamp(
            Lq[:, :, None, :] - Lq[:, None, :, :], -60.0, 0.0))
        gamma = torch.where(mask[None, :, :, None], gamma, 0.0)
        M = scores[..., None] * gamma * dtq[:, None, :, :]      # (b,l,m,h)
        xf = xq.to(wide)
        y_intra = torch.einsum("blmh,bmhp->blhp", M.to(wide), xf)
        y_inter = torch.einsum("blh,bln,bhpn->blhp", torch.exp(Lq).to(wide),
                               Cq.to(wide), state.to(wide))
        w = dtq * torch.exp(Lq[:, -1:, :] - Lq)                  # (b,l,h)
        s_chunk = torch.einsum("blh,blhp,bln->bhpn", w.to(wide), xf,
                               Bq.to(wide))
        state = state * torch.exp(Lq[:, -1])[..., None, None] + s_chunk
        ys.append(y_intra + y_inter)
    y = torch.stack(ys, dim=1).reshape(b, L, h, P)
    return y + Dp * xh.to(wide), state


def _plain_groups(xh, B, C, dt, l_t, Dp, state, Q: int):
    """:func:`plain` with B and C (b, L, G, N): each head's B and C taken
    from its group (the gradients of a group's heads meet there), then
    the loop of :func:`plain` with per-head products."""
    wide = torch.promote_types(xh.dtype, torch.float32)
    b, L, h, P = xh.shape
    N = B.shape[-1]
    nc = L // Q
    grp = heads_of_groups(h, B.shape[2], xh.device)
    xc = xh.reshape(b, nc, Q, h, P)
    Bc = B[:, :, grp].reshape(b, nc, Q, h, N)
    Cc = C[:, :, grp].reshape(b, nc, Q, h, N)
    dtc = dt.reshape(b, nc, Q, h)
    Lcum = l_t.reshape(b, nc, Q, h).cumsum(dim=2)
    mask = torch.tril(torch.ones(Q, Q, dtype=torch.bool, device=xh.device))
    ys = []
    for c in range(nc):
        xq, Bq, Cq = xc[:, c], Bc[:, c], Cc[:, c]
        dtq, Lq = dtc[:, c], Lcum[:, c]
        scores = torch.einsum("blhn,bmhn->blmh", Cq, Bq).to(wide)
        gamma = torch.exp(torch.clamp(
            Lq[:, :, None, :] - Lq[:, None, :, :], -60.0, 0.0))
        gamma = torch.where(mask[None, :, :, None], gamma, 0.0)
        M = scores * gamma * dtq[:, None, :, :]                  # (b,l,m,h)
        xf = xq.to(wide)
        y_intra = torch.einsum("blmh,bmhp->blhp", M.to(wide), xf)
        y_inter = torch.einsum("blh,blhn,bhpn->blhp", torch.exp(Lq).to(wide),
                               Cq.to(wide), state.to(wide))
        w = dtq * torch.exp(Lq[:, -1:, :] - Lq)
        s_chunk = torch.einsum("blh,blhp,blhn->bhpn", w.to(wide), xf,
                               Bq.to(wide))
        state = state * torch.exp(Lq[:, -1])[..., None, None] + s_chunk
        ys.append(y_intra + y_inter)
    y = torch.stack(ys, dim=1).reshape(b, L, h, P)
    return y + Dp * xh.to(wide), state


def ssd_backward(xh, B, C, dt, l_t, Dp, state, dy, dstate, Q: int):
    """The gradients of :func:`plain`'s (y, final state) as the backward
    kernels compute them, written out in PyTorch: ``dy`` (b, L, h, P) and
    ``dstate`` (b, h, P, N, or None) in; (dxh, dB, dC, ddt, dl_t, dDp,
    dstate0) out, each in its operand's type.  Per chunk, with S = C·Bᵀ,
    G = exp(clamp(Lc[l] - Lc[m], -60, 0)) (l >= m), Mt = S·G·dt[m], the
    weights w = dt·exp(Lc[-1] - Lc), H the state at the chunk's start and
    dH the gradient of the state at its end (the recurrence run
    backwards from ``dstate``, adding (exp(Lc)·dy)ᵀ·C each chunk):

    - dx[m] = Σ_l Mt[l,m] dy[l] + w[m] (B[m]·dHᵀ) + D dy[m];
    - dMt = dy·xᵀ; ddt[m] = Σ_l dMt·S·G + dw[m] exp(Lc[-1] - Lc[m]), dw
      = Σ_p x (B·dHᵀ);
    - ∂Lc[l] = Σ_m dMt·dt·S·G (where the clamp passes) − the same summed
      over l for m, + exp(Lc[l]) Σ_p dy (C·Hᵀ), − dw·w, and at the last
      position Σ dw·w + exp(Lc[-1]) Σ dH·H; dl_t is its reverse
      cumulative sum within the chunk;
    - dS = Σ_h dMt·G·dt; dC = dS·B + Σ_h exp(Lc) dy·H; dB = dSᵀ·C +
      Σ_h w x·dH; dD = Σ x·dy.

    B and C in groups (b, L, G, N): each group's heads as a scan of their
    own with the group's B and C, as the kernels run them; the sums over
    heads are then over the group's heads.
    """
    if B.dim() == 4:
        G = B.shape[2]
        hg = xh.shape[2] // G
        heads_of_groups(xh.shape[2], G)
        parts = [ssd_backward(
            xh[:, :, g * hg:(g + 1) * hg], B[:, :, g], C[:, :, g],
            dt[..., g * hg:(g + 1) * hg], l_t[..., g * hg:(g + 1) * hg],
            Dp[g * hg:(g + 1) * hg], state[:, g * hg:(g + 1) * hg],
            dy[:, :, g * hg:(g + 1) * hg],
            None if dstate is None else dstate[:, g * hg:(g + 1) * hg], Q)
            for g in range(G)]
        out = [torch.cat([p[i] for p in parts], dim=d)
               for i, d in ((0, 2), (3, 2), (4, 2), (5, 0), (6, 1))]
        dB = torch.stack([p[1] for p in parts], dim=2)
        dC = torch.stack([p[2] for p in parts], dim=2)
        return out[0], dB, dC, out[1], out[2], out[3], out[4]
    wide = torch.promote_types(xh.dtype, torch.float32)
    b, L, h, P = xh.shape
    N = B.shape[-1]
    nc = L // Q
    x = xh.to(wide).reshape(b, nc, Q, h, P)
    Bc = B.to(wide).reshape(b, nc, Q, N)
    Cc = C.to(wide).reshape(b, nc, Q, N)
    dtc = dt.to(wide).reshape(b, nc, Q, h)
    Lc = l_t.to(wide).reshape(b, nc, Q, h).cumsum(2)
    g = dy.to(wide).reshape(b, nc, Q, h, P)
    S = torch.einsum("bcln,bcmn->bclm", C.reshape(b, nc, Q, N),
                     B.reshape(b, nc, Q, N)).to(wide)
    mask = torch.tril(torch.ones(Q, Q, dtype=torch.bool, device=xh.device))
    mask = mask[None, None, :, :, None]
    diff = Lc[:, :, :, None, :] - Lc[:, :, None, :, :]           # (b,c,l,m,h)
    G = torch.where(mask, torch.exp(torch.clamp(diff, -60.0, 0.0)), 0.0)
    passes = mask & (diff >= -60.0) & (diff <= 0.0)
    dtm = dtc[:, :, None, :, :]
    Mt = S[..., None] * G * dtm
    last = torch.exp(Lc[:, :, -1])                               # (b,c,h)
    e = torch.exp(Lc[:, :, -1:] - Lc)
    w = dtc * e
    chunk = torch.einsum("bclh,bclhp,bcln->bchpn", w, x, Bc)
    H, starts = state.to(wide), []
    for c in range(nc):
        starts.append(H)
        H = H * last[:, c, :, None, None] + chunk[:, c]
    Hs = torch.stack(starts, 1)                                  # (b,c,h,P,N)
    T = torch.einsum("bclh,bclhp,bcln->bchpn", torch.exp(Lc), g, Cc)
    G_ = torch.zeros_like(state, dtype=wide) if dstate is None \
        else dstate.to(wide)
    ends, decay = [None] * nc, [None] * nc
    for c in reversed(range(nc)):
        ends[c] = G_
        decay[c] = (G_ * Hs[:, c]).sum((-1, -2))
        G_ = G_ * last[:, c, :, None, None] + T[:, c]
    dH = torch.stack(ends, 1)
    dM = torch.einsum("bclhp,bcmhp->bclmh", g, x)
    R = torch.einsum("bcmn,bchpn->bcmhp", Bc, dH)
    dx = (torch.einsum("bclmh,bclhp->bcmhp", Mt, g) + w[..., None] * R
          + Dp.to(wide).reshape(h, 1) * g)
    dw = (x * R).sum(-1)
    dd = torch.where(passes, dM * dtm * S[..., None] * G, 0.0)
    dLc = dd.sum(3) - dd.sum(2)
    Y = torch.einsum("bcln,bchpn->bclhp", Cc, Hs)
    dLc = dLc + torch.exp(Lc) * (g * Y).sum(-1) - dw * w
    dLc[:, :, -1] += (dw * w).sum(2) + last * torch.stack(decay, 1)
    ddt = (dM * S[..., None] * G).sum(2) + dw * e
    dl_t = dLc.flip(2).cumsum(2).flip(2)
    dS = (dM * G * dtm).sum(-1)
    dC = (torch.einsum("bclm,bcmn->bcln", dS, Bc)
          + torch.einsum("bclh,bclhp,bchpn->bcln", torch.exp(Lc), g, Hs))
    dB = (torch.einsum("bclm,bcln->bcmn", dS, Cc)
          + torch.einsum("bcmh,bcmhp,bchpn->bcmn", w, x, dH))
    dD = (x * g).sum((0, 1, 2, 4)).reshape(Dp.shape)
    return (dx.reshape(b, L, h, P).to(xh.dtype),
            dB.reshape(b, L, N).to(B.dtype), dC.reshape(b, L, N).to(C.dtype),
            ddt.reshape(b, L, h).to(dt.dtype),
            dl_t.reshape(b, L, h).to(l_t.dtype), dD.to(Dp.dtype),
            G_.to(state.dtype))


def flops(b: int, L: int, h: int, P: int, N: int, Q: int
          ) -> tuple[float, float]:
    """(forward, backward) flops of the scan's products, the least work
    the function needs: C·Bᵀ once per row and chunk, Mt·x over the
    causal pairs, the chunk states and C·Hᵀ per head; the backward twice
    the forward (each product's gradient is two products of its size)."""
    nc = L // Q
    fwd = 2.0 * b * nc * (Q * Q * N + h * (Q * (Q + 1) // 2 * P
                                          + 2 * Q * P * N))
    return fwd, 2.0 * fwd


def route(xh: torch.Tensor) -> str:
    """``"kernel"`` for CUDA tensors other than float64, else
    ``"plain"``: decided from xh's device and type alone."""
    return "kernel" if xh.device.type == "cuda" \
        and xh.dtype != torch.float64 else "plain"


def _count_plain_backward(grad):
    ssd_scan.backward_calls_by_route["plain"] += 1


def ssd_scan(xh, B, C, dt, l_t, Dp, state, Q: int):
    """The scan on its :func:`route`: :class:`SSDScanFn` (the kernels,
    under autograd) or :func:`plain` (whose backward is autograd's through
    the loop, counted by a hook on y)."""
    if route(xh) == "plain":
        y, final = plain(xh, B, C, dt, l_t, Dp, state, Q)
        ssd_scan.launches_by_route["plain"] += 1
        if y.requires_grad:
            y.register_hook(_count_plain_backward)
        return y, final
    return SSDScanFn.apply(xh, B, C, dt, l_t, Dp, state, Q)


ssd_scan.launches = 0
ssd_scan.launches_by_route = {r: 0 for r in ROUTES}
ssd_scan.backward_calls_by_route = {r: 0 for r in ROUTES}


def _check(xh, B, C, Q: int) -> tuple[int, int, int, int, int, int]:
    """(b, L, h, P, N, G) of operands the kernels take; raises
    otherwise."""
    if xh.dim() != 4 or B.dim() not in (3, 4) or C.shape != B.shape:
        raise ValueError(f"ssd_scan: xh (b, L, h, P) and B, C (b, L, N) or "
                         f"(b, L, G, N), got {tuple(xh.shape)}, "
                         f"{tuple(B.shape)}, {tuple(C.shape)}")
    b, L, h, P = xh.shape
    N = B.shape[-1]
    G = B.shape[2] if B.dim() == 4 else 1
    if B.shape[:2] != (b, L) or G <= 0 or h % G:
        raise ValueError(f"ssd_scan: B {tuple(B.shape)} against xh "
                         f"{tuple(xh.shape)}: the groups must split the "
                         f"heads evenly")
    if any(t.stride(-1) != 1 for t in (xh, B, C)):
        raise ValueError("ssd_scan: the kernels read xh, B and C through "
                         "their strides but want their last dim contiguous")
    if xh.dtype not in DTYPES or B.dtype != xh.dtype or C.dtype != xh.dtype:
        raise TypeError(f"ssd_scan: the kernels take xh, B and C in one of "
                        f"{list(DTYPES)}, got {xh.dtype}, {B.dtype}, "
                        f"{C.dtype}")
    if not 0 < Q <= MAX_CHUNK or L % Q or P > MAX_HEADDIM or min(b, h, P,
                                                                  N) <= 0:
        raise ValueError(f"ssd_scan: chunk {Q} must divide L={L} and be at "
                         f"most {MAX_CHUNK}, head dim {P} at most "
                         f"{MAX_HEADDIM}")
    return b, L, h, P, N, G


def _strides(xh, B, C) -> list[int]:
    """x's (b, L, h) strides, then B's and C's (b, L, group): a group's
    stride is N where B and C hold one."""
    def bc(t):
        return [t.stride(0), t.stride(1),
                t.stride(2) if t.dim() == 4 else t.shape[-1]]
    return [xh.stride(0), xh.stride(1), xh.stride(2), *bc(B), *bc(C)]


def _stream(t: torch.Tensor) -> int:
    with torch.cuda.device(t.device):
        return torch.cuda.current_stream().cuda_stream


def forward(xh, B, C, dt, l_t, Dp, state, Q: int):
    """The forward kernels: returns (y, final state) and what the
    backward reads, (Lc, S, Hs): the within-chunk cumulative log-decays
    (b, L, h), S = C·Bᵀ (b, nc, Q, Q) and the chunk-start states
    (b, nc, h, P, N), all float32; S is (b, nc, G, Q, Q) where B and C
    come in G groups.  Counted on the kernel route once the launches
    succeed."""
    b, L, h, P, N, G = _check(xh, B, C, Q)
    nc = L // Q
    f32 = dict(dtype=torch.float32, device=xh.device)
    dt = dt.to(torch.float32).contiguous()
    # the plain version's op, so that the decays are its bits
    Lc = l_t.to(torch.float32).reshape(b, nc, Q, h).cumsum(dim=2) \
        .reshape(b, L, h)
    Dv = Dp.to(torch.float32).reshape(h).contiguous()
    s0 = state.to(torch.float32).contiguous()
    y = torch.empty(b, L, h, P, **f32)
    final = torch.empty(b, h, P, N, **f32)
    S = torch.empty(b, nc, Q, Q, **f32) if B.dim() == 3 else \
        torch.empty(b, nc, G, Q, Q, **f32)
    Hs = torch.empty(b, nc, h, P, N, **f32)
    fn = _build.entry(SOURCE, [ctypes.c_void_p] * 11 + [ctypes.c_int] * 7
                      + [ctypes.c_longlong] * 9 + [ctypes.c_int,
                                                   ctypes.c_void_p])
    _build.check_status(SOURCE, fn(
        *(t.data_ptr() for t in (xh, B, C, dt, Lc, Dv, s0, y, final, S, Hs)),
        b, L, h, P, N, Q, G, *_strides(xh, B, C), DTYPES[xh.dtype],
        _stream(xh)))
    ssd_scan.launches += 1
    ssd_scan.launches_by_route["kernel"] += 1
    return y, final, Lc, S, Hs


def backward_scratch(P: int, N: int) -> int:
    """Floats a (row, chunk, head) of the backward's scratch (each
    state-passing warp's share of the chunk's decay term), as the built
    library states them (``repro_ssd_scan_backward_scratch``)."""
    fn = _build.entry(SOURCE, [ctypes.c_int, ctypes.c_int,
                               ctypes.POINTER(ctypes.c_longlong)],
                      symbol=f"{SOURCE}_backward_scratch")
    slots = ctypes.c_longlong()
    _build.check_status(f"{SOURCE}_backward_scratch",
                        fn(P, N, ctypes.byref(slots)))
    return slots.value


def backward(xh, B, C, dt, Lc, Dp, S, Hs, dy, dstate, Q: int):
    """The backward kernels: (dxh, dB, dC, ddt, dl_t, dDp, dstate0) from
    the forward's operands and what :func:`forward` kept, ``dy``
    (b, L, h, P) and ``dstate`` (the final state's gradient, or None).
    Counted on the kernel route once the launches succeed."""
    b, L, h, P, N, G = _check(xh, B, C, Q)
    nc = L // Q
    f32 = dict(dtype=torch.float32, device=xh.device)
    dy = torch.zeros(b, L, h, P, **f32) if dy is None \
        else dy.to(torch.float32).contiguous()
    dfin = None if dstate is None \
        else dstate.to(torch.float32).contiguous()
    dt = dt.to(torch.float32).contiguous()
    Dv = Dp.to(torch.float32).reshape(h).contiguous()
    dH = torch.empty_like(Hs)
    part = torch.empty(b, nc, h, backward_scratch(P, N), **f32)
    dS = torch.empty_like(S)
    dx = torch.empty(b, L, h, P, dtype=xh.dtype, device=xh.device)
    dB = torch.empty(B.shape, dtype=B.dtype, device=xh.device)
    dC = torch.empty_like(dB)
    ddt = torch.empty(b, L, h, **f32)
    dl_t = torch.empty(b, L, h, **f32)
    dD = torch.empty(b, nc, h, **f32)
    ds0 = torch.empty(b, h, P, N, **f32)
    fn = _build.entry(SOURCE, [ctypes.c_void_p] * 20 + [ctypes.c_int] * 7
                      + [ctypes.c_longlong] * 9 + [ctypes.c_int,
                                                   ctypes.c_void_p],
                      symbol=f"{SOURCE}_backward")
    ptrs = [t.data_ptr() for t in (xh, B, C, dt, Lc, Dv, S, Hs, dy)]
    ptrs.append(None if dfin is None else dfin.data_ptr())
    ptrs += [t.data_ptr() for t in (dH, part, dS, dx, dB, dC, ddt, dl_t, dD,
                                    ds0)]
    _build.check_status(f"{SOURCE}_backward", fn(
        *ptrs, b, L, h, P, N, Q, G, *_strides(xh, B, C), DTYPES[xh.dtype],
        _stream(xh)))
    ssd_scan.backward_calls_by_route["kernel"] += 1
    return dx, dB, dC, ddt, dl_t, dD.sum((0, 1)).reshape(Dp.shape), ds0


class SSDScanFn(torch.autograd.Function):
    """The kernel route under autograd: the forward kernels (span
    ``kernel.ssd_fwd``, phase fwd or recompute), saving the operands with
    Lc, S and the chunk-start states; the backward kernels (span
    ``kernel.ssd_bwd``).  dt and l_t stay separate inputs, so that autograd
    sums the gradients that reach A and dt outside, as it does through
    :func:`plain`."""

    @staticmethod
    def forward(ctx, xh, B, C, dt, l_t, Dp, state, Q):
        ctx.set_materialize_grads(False)
        with torch.no_grad(), obs.span("kernel.ssd_fwd"):
            y, final, Lc, S, Hs = forward(xh, B, C, dt, l_t, Dp, state, Q)
        ctx.save_for_backward(xh, B, C, dt, Lc, Dp, S, Hs)
        ctx.Q = Q
        return y, final

    @staticmethod
    def backward(ctx, dy, dstate):
        xh, B, C, dt, Lc, Dp, S, Hs = ctx.saved_tensors
        with obs.span("kernel.ssd_bwd", "bwd"):
            dx, dB, dC, ddt, dl_t, dD, ds0 = backward(
                xh, B, C, dt, Lc, Dp, S, Hs, dy, dstate, ctx.Q)
        return dx, dB, dC, ddt, dl_t, dD, ds0, None
