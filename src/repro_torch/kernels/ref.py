"""Plain PyTorch versions of the kernels (same contracts).

`ops` takes these for CPU tensors; `chip_smoke.py` holds each CUDA
kernel against them on the card.  Layouts are the model path's.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

NEG_INF = -1e30


def split_matmul_ref(x: torch.Tensor, w: torch.Tensor,
                     bk: Optional[int] = None,
                     acc: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x:(M,K) @ w:(K,N) in fp32, cast to x.dtype.  With `bk`, K runs in
    slices of bk summed into one fp32 accumulator: the operator-splitting
    schedule of the kernel (granularity K/bk).  With `acc` (fp32 (M, N))
    the accumulating form: acc + that fp32 sum, not cast."""
    K = x.shape[-1]
    xf, wf = x.float(), w.float()
    if not bk or bk >= K:
        out = xf @ wf
    else:
        out = None
        for s in range(0, K, bk):
            part = xf[:, s:s + bk] @ wf[s:s + bk]
            out = part if out is None else out + part
    return out.to(x.dtype) if acc is None else acc + out


def split_matmul_dgrad_ref(dy: torch.Tensor, w: torch.Tensor, *,
                           transpose_w: bool = False,
                           bk: Optional[int] = 512) -> torch.Tensor:
    """dx of y = x @ w: dy (M, N) @ w^T for w (K, N); with `transpose_w`
    (y = x @ w^T, w (N, K)) dy @ w.  As the forward: the contracted N in
    slices of `bk` summed into one fp32 accumulator, cast to dy.dtype."""
    return split_matmul_ref(dy, w if transpose_w else w.t(), bk=bk)


def split_matmul_wgrad_ref(x: torch.Tensor, dy: torch.Tensor, *,
                           transpose_w: bool = False,
                           bk: Optional[int] = 512) -> torch.Tensor:
    """dw of y = x @ w: x^T (K, M) @ dy (M, N); with `transpose_w`
    dy^T @ x, shaped (N, K) like the stored weight.  As the forward: the
    contracted M rows in slices of `bk` summed into one fp32
    accumulator, cast to the inputs' dtype."""
    if transpose_w:
        return split_matmul_ref(dy.t(), x, bk=bk)
    return split_matmul_ref(x.t(), dy, bk=bk)


def split_matmul_splitk_ref(x: torch.Tensor, w: torch.Tensor, bk: int,
                            ranges) -> torch.Tensor:
    """The summation order of the CUDA kernel's split-K plans: K is cut
    into `ranges` [(k0, k1), ...] of whole slices of `bk`; within a
    range the slices add into one fp32 accumulator, then the ranges'
    fp32 partials are summed in range order and cast to x.dtype.  The
    backward layouts take it on views: "nt" (x, w.t()), "tn" (x.t(), w).
    """
    xf, wf = x.float(), w.float()
    total = None
    for k0, k1 in ranges:
        acc = None
        for s in range(k0, k1, bk):
            e = min(s + bk, k1)
            part = xf[:, s:e] @ wf[s:e]
            acc = part if acc is None else acc + part
        total = acc if total is None else total + acc
    return total.to(x.dtype)


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool, window: int = 0,
                        q_offset: int = 0, bq: int = 512,
                        bk: int = 1024, return_lse: bool = False):
    """Blockwise online-softmax attention, a line-by-line port of the JAX
    model path's `models/attention.py::flash_attention`.

    q:(B,S,KV,G,hd) k,v:(B,T,KV,hd) -> (B,S,KV,G,hd); with `return_lse`
    also each row's logsumexp m + log(l) of the scaled scores (fp32,
    (B,S,KV,G)), what the backward recomputes the softmax from."""
    B, S, KV, G, hd = q.shape
    T = k.shape[1]
    scale = 1.0 / math.sqrt(hd)
    bq, bk = min(bq, S), min(bk, T)
    dev = q.device
    out = torch.empty(B, S, KV, G, hd, dtype=torch.float32, device=dev)
    lse = torch.empty(B, S, KV, G, dtype=torch.float32, device=dev)
    for q0 in range(0, S, bq):
        qb = q[:, q0:q0 + bq]
        n = qb.shape[1]
        q_pos = q_offset + q0 + torch.arange(n, device=dev)
        m = torch.full((B, KV, G, n), NEG_INF, device=dev)
        l = torch.zeros((B, KV, G, n), device=dev)
        acc = torch.zeros((B, KV, G, n, hd), device=dev)
        for k0 in range(0, T, bk):
            kb, vb = k[:, k0:k0 + bk], v[:, k0:k0 + bk]
            k_pos = k0 + torch.arange(kb.shape[1], device=dev)
            s = torch.einsum("bqkgh,btkh->bkgqt", qb.float(),
                             kb.float()) * scale
            msk = torch.ones(n, kb.shape[1], dtype=torch.bool, device=dev)
            if causal:
                msk &= k_pos[None, :] <= q_pos[:, None]
            if window:
                msk &= (q_pos[:, None] - k_pos[None, :]) < window
            s = torch.where(msk, s, torch.tensor(NEG_INF, device=dev))
            m_new = torch.maximum(m, s.amax(-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(-1)
            acc = acc * corr[..., None] + torch.einsum(
                "bkgqt,btkh->bkgqh", p, vb.float())
            m = m_new
        o = acc / torch.clamp(l, min=1e-30)[..., None]
        out[:, q0:q0 + n] = o.permute(0, 3, 1, 2, 4)
        lse[:, q0:q0 + n] = (m + torch.log(l)).permute(0, 3, 1, 2)
    if return_lse:
        return out.to(q.dtype), lse
    return out.to(q.dtype)


def flash_attention_bwd_ref(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, o: torch.Tensor,
                            lse: torch.Tensor, dout: torch.Tensor, *,
                            causal: bool, window: int = 0,
                            q_offset: int = 0, bq: int = 512) -> tuple:
    """The CUDA backward's arithmetic in fp32, blockwise over query rows:
    D = rowsum(dO o); per block P = exp(q.k^T scale - lse) recomputed
    (0 where masked), dv += P^T dO, dP = dO v^T, dS = P (dP - D),
    dq = dS k scale, dk += dS^T q scale; dk, dv summed over the G query
    heads of each kv head.  -> (dq, dk, dv) in the inputs' dtypes."""
    B, S, KV, G, hd = q.shape
    T = k.shape[1]
    scale = 1.0 / math.sqrt(hd)
    dev = q.device
    kf, vf = k.float(), v.float()
    dsum = (dout.float() * o.float()).sum(-1)            # (B,S,KV,G)
    dq = torch.empty(B, S, KV, G, hd, dtype=torch.float32, device=dev)
    dk = torch.zeros(B, T, KV, hd, dtype=torch.float32, device=dev)
    dv = torch.zeros_like(dk)
    k_pos = torch.arange(T, device=dev)
    for q0 in range(0, S, bq):
        qb, gb = q[:, q0:q0 + bq].float(), dout[:, q0:q0 + bq].float()
        n = qb.shape[1]
        q_pos = q_offset + q0 + torch.arange(n, device=dev)
        msk = torch.ones(n, T, dtype=torch.bool, device=dev)
        if causal:
            msk &= k_pos[None, :] <= q_pos[:, None]
        if window:
            msk &= (q_pos[:, None] - k_pos[None, :]) < window
        s = torch.einsum("bqkgh,btkh->bkgqt", qb, kf) * scale
        l_b = lse[:, q0:q0 + n].permute(0, 2, 3, 1)[..., None]
        p = torch.where(msk, torch.exp(s - l_b), torch.zeros((), device=dev))
        dv += torch.einsum("bkgqt,bqkgh->btkh", p, gb)
        dp = torch.einsum("bqkgh,btkh->bkgqt", gb, vf)
        d_b = dsum[:, q0:q0 + n].permute(0, 2, 3, 1)[..., None]
        ds = p * (dp - d_b)
        dq[:, q0:q0 + n] = torch.einsum("bkgqt,btkh->bqkgh", ds, kf) * scale
        dk += torch.einsum("bkgqt,bqkgh->btkh", ds, qb) * scale
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def ssd_scan_ref(x: torch.Tensor, dt: torch.Tensor, a_log: torch.Tensor,
                 b: torch.Tensor, c: torch.Tensor, *, chunk: int,
                 init_state: Optional[torch.Tensor] = None) -> tuple:
    """Mamba2 SSD chunk scan, a line-by-line port of the JAX model path's
    `models/ssm.py::ssd_chunk_scan` (ragged S padded to a multiple of
    the chunk, mask before exp, inter-chunk state carried in fp32).

    x:(B,S,nh,hd) dt:(B,S,nh) a_log:(nh,) [log(-A)] b,c:(B,S,ns)
    -> (y fp32 (B,S,nh,hd), final_state fp32 (B,nh,hd,ns))."""
    B, S, nh, hd = x.shape
    ns = b.shape[-1]
    Q = min(chunk, S)
    pad = (-S) % Q
    if pad:
        x = torch.nn.functional.pad(x, (0, 0, 0, 0, 0, pad))
        dt = torch.nn.functional.pad(dt, (0, 0, 0, pad))
        b = torch.nn.functional.pad(b, (0, 0, 0, pad))
        c = torch.nn.functional.pad(c, (0, 0, 0, pad))
    Sp = S + pad
    nc = Sp // Q

    a = -torch.exp(a_log.float())                        # (nh,) A < 0
    dt = dt.float()
    dA = dt * a                                          # (B,Sp,nh)
    xd = x.float() * dt[..., None]                       # dt-weighted input

    dAc = dA.reshape(B, nc, Q, nh)
    xc = xd.reshape(B, nc, Q, nh, hd)
    bc = b.reshape(B, nc, Q, ns).float()
    cc = c.reshape(B, nc, Q, ns).float()

    csum = torch.cumsum(dAc, dim=2)                      # (B,nc,Q,nh)
    diff = csum[:, :, :, None, :] - csum[:, :, None, :, :]  # (B,nc,Q,Q,nh)
    mask = torch.tril(torch.ones(Q, Q, dtype=torch.bool, device=x.device))
    # mask BEFORE exp: masked (i<j) entries have diff > 0
    att = torch.exp(diff.masked_fill(~mask[None, None, :, :, None],
                                     float("-inf")))
    cb = torch.einsum("bnis,bnjs->bnij", cc, bc)         # (B,nc,Q,Q)
    y_intra = torch.einsum("bnij,bnijh,bnjhd->bnihd", cb, att, xc)

    decay_to_end = torch.exp(csum[:, :, -1:, :] - csum)  # (B,nc,Q,nh)
    states = torch.einsum("bnjs,bnjh,bnjhd->bnhds", bc, decay_to_end, xc)

    chunk_decay = torch.exp(csum[:, :, -1, :])           # (B,nc,nh)
    s = (init_state.float() if init_state is not None
         else torch.zeros(B, nh, hd, ns, device=x.device))
    prev = []
    for n in range(nc):
        prev.append(s)
        s = s * chunk_decay[:, n, :, None, None] + states[:, n]
    prev_states = torch.stack(prev, dim=1)               # (B,nc,nh,hd,ns)

    y_inter = torch.einsum("bnis,bnih,bnhds->bnihd", cc, torch.exp(csum),
                           prev_states)
    y = (y_intra + y_inter).reshape(B, Sp, nh, hd)[:, :S]
    return y, s


def ssd_scan_bwd_ref(x: torch.Tensor, dt: torch.Tensor, a_log: torch.Tensor,
                     b: torch.Tensor, c: torch.Tensor, dy: torch.Tensor, *,
                     chunk: int, d_final_state: Optional[torch.Tensor] = None,
                     init_state: Optional[torch.Tensor] = None) -> tuple:
    """The gradient of `ssd_scan_ref` in the chunk-parallel form the
    CUDA backward computes, written out (not autograd).  dy (fp32, like
    y) and d_final_state (None: zero) are the cotangents of y and of the
    final state; `init_state` (no gradient taken) is the forward's.
    -> (dx in x's dtype, ddt fp32, da_log fp32, db and dc in b's dtype).

    With xd = dt x, L_ij = exp(csum_i - csum_j) (i >= j, else 0),
    w_j = exp(last - csum_j), e_i = exp(csum_i), P the carried state
    S_prev of the chunk and D the cotangent of the state leaving it:
      dS_prev[n] = sum_i e_i dy_i (x) c_i + exp(last_n) D[n],
      D[n] = dS_prev[n + 1] (D[last chunk] = d_final_state);
      dxd_j = sum_i CB_ij L_ij dy_i + w_j D b_j;
      dCB_ij = (dy_i . xd_j) L_ij summed over heads -> dc = dCB b
      + e (dy P), db = dCB^T c + w (xd D);
      dcsum_i = sum_j Z_ij - sum_j Z_ji (Z = dCB_h * CB) + dy_i . y_inter_i
      - w_i (xd_i . D b_i), plus dlast = sum_j w_j (xd_j . D b_j)
      + exp(last) <D, P> at the chunk's last row;
      dA = reverse cumsum of dcsum, ddt = dA a + dxd . x, dx = dt dxd,
      da_log = sum dA dt a."""
    B, S, nh, hd = x.shape
    ns = b.shape[-1]
    Q = min(chunk, S)
    nc = -(-S // Q)
    pad = nc * Q - S
    pad_seq = lambda t: torch.nn.functional.pad(
        t.float(), (0, 0) * (t.ndim - 2) + (0, pad))
    xr = pad_seq(x).reshape(B, nc, Q, nh, hd)
    dtc = pad_seq(dt).reshape(B, nc, Q, nh)           # 0 past S
    bc = pad_seq(b).reshape(B, nc, Q, ns)
    cc = pad_seq(c).reshape(B, nc, Q, ns)
    dyc = pad_seq(dy).reshape(B, nc, Q, nh, hd)
    a = -torch.exp(a_log.float())
    xd = xr * dtc[..., None]
    csum = torch.cumsum(dtc * a, dim=2)               # (B,nc,Q,nh)
    last = csum[:, :, -1]                             # flat past S
    mask = torch.tril(torch.ones(Q, Q, dtype=torch.bool, device=x.device))
    L = torch.exp((csum[:, :, :, None] - csum[:, :, None])
                  .masked_fill(~mask[None, None, :, :, None], float("-inf")))
    cb = torch.einsum("bnis,bnjs->bnij", cc, bc)
    w = torch.exp(last[:, :, None] - csum)            # (B,nc,Q,nh)
    e = torch.exp(csum)

    # the carried states, as the forward makes them
    s_loc = torch.einsum("bnjs,bnjh,bnjhd->bnhds", bc, w, xd)
    s = (init_state.float() if init_state is not None
         else torch.zeros(B, nh, hd, ns, device=x.device))
    prev = []
    for n in range(nc):
        prev.append(s)
        s = s * torch.exp(last[:, n])[..., None, None] + s_loc[:, n]
    P = torch.stack(prev, dim=1)                      # (B,nc,nh,hd,ns)

    # the state gradient, backwards over the chunks
    ds_y = torch.einsum("bnih,bnihd,bnis->bnhds", e, dyc, cc)
    g = (d_final_state.float() if d_final_state is not None
         else torch.zeros(B, nh, hd, ns, device=x.device))
    dst = [None] * nc
    for n in reversed(range(nc)):
        dst[n] = g
        g = ds_y[:, n] + torch.exp(last[:, n])[..., None, None] * g
    D = torch.stack(dst, dim=1)                       # (B,nc,nh,hd,ns)
    dlast = torch.exp(last) * (D * P).sum((-2, -1))   # (B,nc,nh)

    # within the chunk: the quadratic form as an attention backward
    dcb_h = torch.einsum("bnihd,bnjhd->bnijh", dyc, xd) * L
    z = dcb_h * cb[..., None]
    dcsum = z.sum(3) - z.sum(2)
    dxd = torch.einsum("bnij,bnijh,bnihd->bnjhd", cb, L, dyc)
    dcb = dcb_h.sum(-1)
    dc = torch.einsum("bnij,bnjs->bnis", dcb, bc) + torch.einsum(
        "bnih,bnihd,bnhds->bnis", e, dyc, P)
    db = torch.einsum("bnij,bnis->bnjs", dcb, cc)
    y_inter = torch.einsum("bnis,bnih,bnhds->bnihd", cc, e, P)
    dcsum = dcsum + (dyc * y_inter).sum(-1)
    # the chunk's state: S_loc = sum_j w_j xd_j (x) b_j
    u = torch.einsum("bnjs,bnhds->bnjhd", bc, D)      # D b_j
    dxd = dxd + w[..., None] * u
    db = db + torch.einsum("bnjh,bnjhd,bnhds->bnjs", w, xd, D)
    dww = (xd * u).sum(-1) * w                        # dw_j w_j
    dcsum = dcsum - dww
    dcsum[:, :, -1] += dlast + dww.sum(2)

    dA = torch.flip(torch.cumsum(torch.flip(dcsum, [2]), 2), [2])
    ddt = dA * a + (dxd * xr).sum(-1)
    dx = dxd * dtc[..., None]
    da_log = (dA * dtc).sum((0, 1, 2)) * a
    unpad = lambda t: t.reshape(B, nc * Q, *t.shape[3:])[:, :S]
    return (unpad(dx).to(x.dtype), unpad(ddt), da_log,
            unpad(db).to(b.dtype), unpad(dc).to(c.dtype))


def _bf16_terms(v: torch.Tensor, n: int) -> list:
    """`v` (fp32) as `n` bf16 terms held in fp32: term t is bf16 of what
    the terms before it left over (n = 3 holds an fp32 value exactly)."""
    out = []
    for _ in range(n):
        t = v.to(torch.bfloat16).float()
        out.append(t)
        v = v - t
    return out


def _split_mm(a: torch.Tensor, b: torch.Tensor, na: int, nb: int,
              order: int, eq: str) -> torch.Tensor:
    """einsum(eq, a, b) as the kernel's tensor-core products: each side
    cut into `na` / `nb` bf16 terms, the products of the term pairs
    (i, j) with i + j <= order summed in fp32."""
    ta, tb = _bf16_terms(a, na), _bf16_terms(b, nb)
    out = None
    for i, u in enumerate(ta):
        for j, v in enumerate(tb):
            if i + j <= order:
                part = torch.einsum(eq, u, v)
                out = part if out is None else out + part
    return out


def ssd_decay_matrix(csum: torch.Tensor, cb: torch.Tensor,
                     dtc: torch.Tensor, tile: int = 64) -> torch.Tensor:
    """G = mask * exp(csum_i - csum_j) * cb_ij * dt_j of each chunk, as
    the CUDA kernel forms it over its `tile`-row tiles: in a diagonal
    tile one exp, (exp * cb) * dt; left of it, with r the last row of
    j's tile, exp(csum_i - csum_r) * (exp(csum_r - csum_j) * dt_j * cb),
    two factors <= 1.  csum, dtc (B,nc,Q,nh); cb (B,nc,Q,Q) ->
    (B,nc,Q,Q,nh)."""
    Q = csum.shape[2]
    idx = torch.arange(Q, device=csum.device)
    ti, tj = idx[:, None] // tile, idx[None, :] // tile
    left = (ti > tj)[None, None, :, :, None]
    diag = ((ti == tj) & (idx[:, None] >= idx[None, :]))[None, None, :, :,
                                                          None]
    r = torch.clamp(idx // tile * tile + tile - 1, max=Q - 1)
    cr = csum[:, :, r]                     # csum at the end of j's tile
    row = torch.exp((csum[:, :, :, None] - cr[:, :, None])
                    .masked_fill(~left, float("-inf")))
    col = torch.exp(cr - csum) * dtc
    g_left = row * (col[:, :, None] * cb[..., None])
    g_diag = torch.exp((csum[:, :, :, None] - csum[:, :, None])
                       .masked_fill(~diag, float("-inf"))) \
        * cb[..., None] * dtc[:, :, None]
    return g_left + g_diag


def ssd_scan_split_ref(x: torch.Tensor, dt: torch.Tensor,
                       a_log: torch.Tensor, b: torch.Tensor,
                       c: torch.Tensor, *, chunk: int,
                       init_state: Optional[torch.Tensor] = None) -> tuple:
    """The arithmetic of the CUDA kernel's three passes
    (`csrc/ssd_scan.cu`), with its operand splits: every product runs
    on bf16 terms with fp32 sums.  With bf16 inputs, x, b and c are one
    exact term and each fp32 factor (x*w, G, the carried state) two
    terms, pairs up to index sum 1 (two products); with f32 inputs every
    operand is three terms, pairs up to index sum 2 (six products).
    Same contract as `ssd_scan_ref`.

    1. chunk states: S_loc = (x*w)^T b, w_j = exp(csum_last - csum_j) dt_j;
    2. state passing: S_prev[c] = S, S = S exp(csum_last[c]) + S_loc[c];
    3. chunk scan: y = (mask * exp(csum_i - csum_j) * (c b^T) * dt_j) x
       + exp(csum_i) * (c S_prev^T), the decay factored left of the
       diagonal tiles as the kernel does (`ssd_decay_matrix`)."""
    B, S, nh, hd = x.shape
    ns = b.shape[-1]
    Q = min(chunk, S)
    nc = -(-S // Q)
    pad = nc * Q - S
    ni, nd, order = (1, 2, 1) if x.dtype == torch.bfloat16 else (3, 3, 2)
    pad_seq = lambda t: torch.nn.functional.pad(
        t.float(), (0, 0) * (t.ndim - 2) + (0, pad))
    xc = pad_seq(x).reshape(B, nc, Q, nh, hd)
    bc = pad_seq(b).reshape(B, nc, Q, ns)
    cc = pad_seq(c).reshape(B, nc, Q, ns)
    dtc = pad_seq(dt).reshape(B, nc, Q, nh)          # 0 past S
    csum = torch.cumsum(dtc * -torch.exp(a_log.float()), dim=2)
    last = csum[:, :, -1]                             # (B,nc,nh)

    # 1. chunk states (B,nc,nh,hd,ns)
    w = torch.exp(last[:, :, None] - csum) * dtc      # (B,nc,Q,nh)
    s_loc = _split_mm(xc * w[..., None], bc, nd, ni, order,
                      "bnjhp,bnjk->bnhpk")
    # 2. state passing
    s = (init_state.float() if init_state is not None
         else torch.zeros(B, nh, hd, ns, device=x.device))
    prev = []
    for n in range(nc):
        prev.append(s)
        s = s * torch.exp(last[:, n])[..., None, None] + s_loc[:, n]
    s_prev = torch.stack(prev, dim=1)
    # 3. chunk scan
    cb = _split_mm(cc, bc, ni, ni, order, "bnik,bnjk->bnij")
    g = ssd_decay_matrix(csum, cb, dtc)
    y = _split_mm(g, xc, nd, ni, order, "bnijh,bnjhp->bnihp")
    y = y + torch.exp(csum)[..., None] * _split_mm(
        cc, s_prev, ni, nd, order, "bnik,bnhpk->bnihp")
    return y.reshape(B, nc * Q, nh, hd)[:, :S], s


def ssd_sequential_ref(x: torch.Tensor, dt: torch.Tensor,
                       a_log: torch.Tensor, b: torch.Tensor,
                       c: torch.Tensor,
                       init_state: Optional[torch.Tensor] = None) -> tuple:
    """The naive per-step recurrence, a port of the JAX `models/ssm.py::
    ssd_ref` oracle.  Same contract as `ssd_scan_ref`."""
    B, S, nh, hd = x.shape
    ns = b.shape[-1]
    a = -torch.exp(a_log.float())
    s = (init_state.float() if init_state is not None
         else torch.zeros(B, nh, hd, ns, device=x.device))
    dt = dt.float()
    ys = []
    for t in range(S):
        dec = torch.exp(dt[:, t] * a)                    # (B,nh)
        upd = torch.einsum("bs,bnh->bnhs", b[:, t].float(),
                           x[:, t].float() * dt[:, t][..., None])
        s = s * dec[:, :, None, None] + upd
        ys.append(torch.einsum("bs,bnhs->bnh", c[:, t].float(), s))
    return torch.stack(ys, dim=1), s
