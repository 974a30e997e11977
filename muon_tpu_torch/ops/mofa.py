"""The per-factor passes of the MOFA+ sweeps over the residual E
(counterpart of the loop bodies of muon_tpu/models/mofa.py ``_make_step``
and ``_make_svi_step``).

    col_dot       T17  <- zk @ E (w_body), (E * E).sum(0) (the τ update)
    w_posterior   T18  <- w_body's posterior of one factor's weights
    row_dot       T19  <- Es[m] @ tsw (z_body; masked: B @ tSWW[:, k], B @ tSW2[:, k])
    rank1_update  T20  <- E + zk ⊗ δ and E + δ ⊗ swk (times B where masked)
    rank1_col_dot      <- T20 then T17 of the next factor, one pass over E
    rank1_row_dot      <- T20 then T19 of the next factor, one pass over E
    col_dot_posterior, rank1_col_dot_posterior
                       <- T17 and rank1_col_dot with T18 of the factor they
                          sum in their finish (``WPost`` holds its operands)
    bound_refresh T23  <- the bernoulli / poisson bound refresh at the start of
                          a sweep: precisions T, residual E, SVI target
                          (csrc/mofa_kernels.cu)

E is (N, D) float32, contiguous, one per view; a masked view's B has E's
shape. A vector argument may be a strided view (column k of a row-major
(N, K) or (D, K) tensor) or, where a scalar is meant, a 0-dim tensor: the
kernels take each with its stride, so the sweeps slice and never copy.
``w_posterior`` writes column k of the four weight tensors and
``rank1_update`` (and the two fused passes) write E, all in place; the
sweeps work on their own copies of the state. The fused passes give the
bits of T20 then T17 or T19: the sweeps call them between two factors. The
``_posterior`` variants give the bits of T17 or ``rank1_col_dot`` then T18
(one device function is T18's body in both), and write δ into one of the
two buffers of their ``WPost``, by the factor's parity, since the pass
still reads the previous factor's δ.

Each wrapper runs its plain PyTorch version for tensors on the CPU; for CUDA
tensors it launches its kernel or raises.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from . import _kernels
from .device import on_card

__all__ = [
    "col_dot", "col_dot_plain", "w_posterior", "w_posterior_plain",
    "row_dot", "row_dot_plain", "rank1_update", "rank1_update_plain",
    "rank1_col_dot", "rank1_col_dot_plain", "rank1_row_dot", "rank1_row_dot_plain",
    "WPost", "col_dot_posterior", "col_dot_posterior_plain", "rank1_col_dot_posterior",
    "rank1_col_dot_posterior_plain",
    "bound_refresh", "bound_refresh_plain",
]

# rows per partial column sum of T17 (kCdTile in the source)
_TILE_ROWS = 256
_INT_MAX = 2**31 - 1
# T17's per-strip counters on each device: zero between calls, since the
# kernel's last block of a strip resets its counter; one T17 runs at a time
# on a device (the port launches every kernel on the current stream)
_CD_DONE = {}


def _matrix(t: torch.Tensor, name: str, device, shape=None) -> Tuple[int, int]:
    if t.device != device or t.dtype != torch.float32 or t.dim() != 2 \
            or not t.is_contiguous() or (shape is not None and tuple(t.shape) != shape):
        want = "2-D" if shape is None else f"{shape}"
        raise ValueError(f"{name} must be a contiguous {want} float32 tensor on {device}, "
                         f"got {t.dtype} {tuple(t.shape)} on {t.device}")
    n, d = t.shape
    if max(n, d) > _INT_MAX:
        raise ValueError(f"{name} of shape {(n, d)} exceeds the int32 range")
    return n, d


def _vector(t: torch.Tensor, length: int, name: str, device, scalar_ok=False,
            broadcast_ok=False):
    """(pointer, stride in elements) of a float32 vector of ``length``
    entries with any positive stride (or stride 0, one value broadcast, with
    ``broadcast_ok``), or of a 0-dim tensor (stride 0)."""
    if t.device != device or t.dtype != torch.float32:
        raise ValueError(f"{name} must be a float32 tensor on {device}, got {t.dtype} "
                         f"on {t.device}")
    if t.dim() == 0 and scalar_ok:
        return t.data_ptr(), 0
    if t.dim() != 1 or t.shape[0] != length or (
            length > 1 and t.stride(0) < (0 if broadcast_ok else 1)):
        raise ValueError(f"{name} must have shape ({length},) and a positive stride, got "
                         f"{tuple(t.shape)} with strides {t.stride()}")
    return t.data_ptr(), t.stride(0)


# ---------------------------------------------------------------------------
# T17
# ---------------------------------------------------------------------------


def col_dot(E: torch.Tensor, z: Optional[torch.Tensor] = None) -> torch.Tensor:
    """T17: ``u (D,)`` with u[d] = Σ_n z[n]·E[n, d]; without ``z``,
    Σ_n E[n, d]². ``z`` may be a strided column or a broadcast (stride 0).
    Summed in a fixed order (tiles of 256 rows, then the tiles in index
    order), so the same inputs give the same bits.

    One launch: the last block of each column strip adds the strip's tiles,
    found by a per-strip counter that the kernel leaves at zero. The
    counters are kept per device (``_CD_DONE``) and shared across calls, so
    T17 relies on the port's kernels running on a single stream a device:
    two T17 calls in flight at once on one device would share them."""
    if not on_card(E):
        return col_dot_plain(E, z)
    n, d = _matrix(E, "E", E.device)
    z_ptr, z_stride = (0, 0) if z is None else _vector(z, n, "z", E.device, broadcast_ok=True)
    partial, done, u = _col_dot_scratch(E.device, n, d)
    _kernels.launch("mofa_col_dot", E.device, E.data_ptr(), z_ptr, z_stride, n, d,
                    partial.data_ptr(), done.data_ptr(), u.data_ptr())
    return u


def _col_dot_scratch(device, n: int, d: int):
    """T17's partial sums (one row a tile of 256 rows), its per-strip
    counters (``_CD_DONE``) and the output u."""
    partial = torch.empty((max(1, -(-n // _TILE_ROWS)), d), dtype=torch.float32, device=device)
    u = torch.empty(d, dtype=torch.float32, device=device)
    strips = -(-d // 32)  # the 4-byte variant's
    done = _CD_DONE.get(device)
    if done is None or done.numel() < strips:
        done = _CD_DONE[device] = torch.zeros(max(strips, 1024), dtype=torch.int32,
                                              device=device)
    return partial, done, u


def col_dot_plain(E: torch.Tensor, z: Optional[torch.Tensor] = None) -> torch.Tensor:
    return (E * E).sum(dim=0) if z is None else z @ E


# ---------------------------------------------------------------------------
# T18
# ---------------------------------------------------------------------------


def w_posterior(
    u: torch.Tensor, tau: torch.Tensor, z2: torch.Tensor, zz: torch.Tensor,
    alpha: torch.Tensor, ln_alpha: torch.Tensor, theta_ln: torch.Tensor,
    theta_ln1m: torch.Tensor, m: int, k: int,
    W_hat: torch.Tensor, W_var: torch.Tensor, S: torch.Tensor, SW: torch.Tensor,
    spikeslab: bool = True, scale: Optional[float] = None,
) -> torch.Tensor:
    """T18: the posterior of factor ``k`` of view ``m``'s weights from
    ``u = zk @ E``: a = τ·z2 + α[m, k]; b = τ·(u + sw·zz), or with ``scale``
    (the stochastic sweep, z2 and zz already scaled) τ·scale·u + τ·sw·zz;
    ŵ = b/a, v = 1/a, s = σ(lnθ − ln(1−θ) + ½ln α − ½ln a + ½b²/a) or 1,
    sw' = s·ŵ. Writes column k of ``W_hat``, ``W_var``, ``S``, ``SW``
    ((D, K), in place) and returns δ = sw − sw' (D,). ``z2`` and ``zz`` are
    0-dim (an unmasked view) or (D,); the hyperparameters are the (M, K)
    tensors, read on the device."""
    if not on_card(SW):
        return w_posterior_plain(u, tau, z2, zz, alpha, ln_alpha, theta_ln, theta_ln1m,
                                 m, k, W_hat, W_var, S, SW, spikeslab, scale)
    dev = SW.device
    d, K = _matrix(SW, "SW", dev)
    for name, t in (("W_hat", W_hat), ("W_var", W_var), ("S", S)):
        _matrix(t, name, dev, (d, K))
    if not 0 <= k < K:
        raise ValueError(f"factor {k} outside 0..{K - 1}")
    u_ptr, u_stride = _vector(u, d, "u", dev)
    tau_ptr, tau_stride = _vector(tau, d, "tau", dev)
    if d > 1 and (u_stride != 1 or tau_stride != 1):
        raise ValueError("u and tau must be contiguous")
    z2_ptr, z2_stride = _vector(z2, d, "z2", dev, scalar_ok=True)
    zz_ptr, zz_stride = _vector(zz, d, "zz", dev, scalar_ok=True)
    M = alpha.shape[0] if alpha.dim() == 2 else -1
    if not 0 <= m < M:
        raise ValueError(f"view {m} outside the hyperparameters' {M} rows")
    hyper = []
    for name, t in (("alpha", alpha), ("ln_alpha", ln_alpha), ("theta_ln", theta_ln),
                    ("theta_ln1m", theta_ln1m)):
        _matrix(t, name, dev, (M, K))
        hyper.append(t.data_ptr() + 4 * (m * K + k))
    delta = torch.empty(d, dtype=torch.float32, device=dev)
    _kernels.launch(
        "mofa_w_posterior", dev, u_ptr, tau_ptr, z2_ptr, z2_stride, zz_ptr, zz_stride,
        *hyper, float(1.0 if scale is None else scale), int(scale is not None),
        int(bool(spikeslab)), d, K, int(k), W_hat.data_ptr(), W_var.data_ptr(),
        S.data_ptr(), SW.data_ptr(), delta.data_ptr(),
    )
    return delta


def w_posterior_plain(
    u: torch.Tensor, tau: torch.Tensor, z2: torch.Tensor, zz: torch.Tensor,
    alpha: torch.Tensor, ln_alpha: torch.Tensor, theta_ln: torch.Tensor,
    theta_ln1m: torch.Tensor, m: int, k: int,
    W_hat: torch.Tensor, W_var: torch.Tensor, S: torch.Tensor, SW: torch.Tensor,
    spikeslab: bool = True, scale: Optional[float] = None,
) -> torch.Tensor:
    swk = SW[:, k]
    a = tau * z2 + alpha[m, k]
    if scale is None:
        b = tau * (u + swk * zz)
    else:
        b = tau * scale * u + tau * swk * zz
    w_hat = b / a
    if spikeslab:
        lam = (theta_ln[m, k] - theta_ln1m[m, k] + 0.5 * ln_alpha[m, k]
               - 0.5 * torch.log(a) + 0.5 * b * b / a)
        s = torch.sigmoid(lam)
    else:
        s = torch.ones_like(w_hat)
    sw_new = s * w_hat
    delta = swk - sw_new
    W_hat[:, k] = w_hat
    W_var[:, k] = 1.0 / a
    S[:, k] = s
    SW[:, k] = sw_new
    return delta


class WPost:
    """T18's operands for the K factors of one view's weight sweep, checked
    once: ``tau`` (D,); ``z2s``, ``zzs`` (K,) (an unmasked view: factor k's
    value is broadcast) or (K, D); the (M, K) hyperparameters and the view
    ``m``; the four (D, K) weight tensors, column k written in place; as
    :func:`w_posterior` takes them a factor at a time. On the card it holds
    the pointers and two δ buffers (D,), factor k's δ written into the one
    of k's parity."""

    def __init__(self, tau, z2s, zzs, alpha, ln_alpha, theta_ln, theta_ln1m, m: int,
                 W_hat, W_var, S, SW, spikeslab: bool = True, scale: Optional[float] = None):
        self.tau, self.z2s, self.zzs, self.m = tau, z2s, zzs, m
        self.hyper = (alpha, ln_alpha, theta_ln, theta_ln1m)
        self.W = (W_hat, W_var, S, SW)
        self.spikeslab, self.scale = bool(spikeslab), scale
        if not on_card(SW):
            return
        dev = SW.device
        d, K = _matrix(SW, "SW", dev)
        for name, t in (("W_hat", W_hat), ("W_var", W_var), ("S", S)):
            _matrix(t, name, dev, (d, K))
        tau_ptr, tau_stride = _vector(tau, d, "tau", dev)
        if d > 1 and tau_stride != 1:
            raise ValueError("tau must be contiguous")
        per_k = []
        for name, t in (("z2s", z2s), ("zzs", zzs)):
            if t.device != dev or t.dtype != torch.float32 or t.dim() not in (1, 2) \
                    or t.shape[0] != K or (t.dim() == 2 and t.shape[1] != d):
                raise ValueError(f"{name} must be a float32 ({K},) or ({K}, {d}) tensor on "
                                 f"{dev}, got {t.dtype} {tuple(t.shape)} on {t.device}")
            per_k.append((t.data_ptr(), t.stride(0), t.stride(1) if t.dim() == 2 else 0))
        M = alpha.shape[0] if alpha.dim() == 2 else -1
        if not 0 <= m < M:
            raise ValueError(f"view {m} outside the hyperparameters' {M} rows")
        for name, t in zip(("alpha", "ln_alpha", "theta_ln", "theta_ln1m"), self.hyper):
            _matrix(t, name, dev, (M, K))
        self.d, self.K, self._per_k = d, K, per_k
        self._head = tau_ptr
        self._tail = (float(1.0 if scale is None else scale), int(scale is not None),
                      int(self.spikeslab), K)
        self._W = tuple(w.data_ptr() for w in self.W)
        self.deltas = torch.empty((2, d), dtype=torch.float32, device=dev)

    def args(self, k: int):
        """The kernel's arguments after u and d for factor ``k``, and the δ
        buffer they write."""
        if not 0 <= k < self.K:
            raise ValueError(f"factor {k} outside 0..{self.K - 1}")
        (z2p, z2k, z2c), (zzp, zzk, zzc) = self._per_k
        hyper = (t.data_ptr() + 4 * (self.m * self.K + k) for t in self.hyper)
        delta = self.deltas[k % 2]
        return (self._head, z2p + 4 * k * z2k, z2c, zzp + 4 * k * zzk, zzc, *hyper,
                *self._tail, k, *self._W, delta.data_ptr()), delta

    def plain(self, u: torch.Tensor, k: int) -> torch.Tensor:
        """``w_posterior_plain`` of factor ``k`` from ``u``."""
        return w_posterior_plain(u, self.tau, self.z2s[k], self.zzs[k], *self.hyper, self.m, k,
                                 *self.W, self.spikeslab, self.scale)


def col_dot_posterior(E: torch.Tensor, z: torch.Tensor, post: WPost, k: int) -> torch.Tensor:
    """T17's ``u = z @ E`` with T18 of factor ``k`` in its finish: the bits
    of ``col_dot`` then ``w_posterior``. Writes column k of the weights and
    returns δ (on the card one of ``post``'s buffers)."""
    if not on_card(E):
        return col_dot_posterior_plain(E, z, post, k)
    n, d = _matrix(E, "E", E.device)
    if d != post.d:
        raise ValueError(f"E has {d} columns where the weights have {post.d} rows")
    z_ptr, z_stride = _vector(z, n, "z", E.device, broadcast_ok=True)
    partial, done, u = _col_dot_scratch(E.device, n, d)
    args, delta = post.args(k)
    _kernels.launch("mofa_col_dot_posterior", E.device, E.data_ptr(), z_ptr, z_stride, n, d,
                    partial.data_ptr(), done.data_ptr(), u.data_ptr(), *args)
    return delta


def col_dot_posterior_plain(E: torch.Tensor, z: torch.Tensor, post: WPost,
                            k: int) -> torch.Tensor:
    return post.plain(col_dot_plain(E, z), k)


def rank1_col_dot_posterior(E: torch.Tensor, x: torch.Tensor, y: torch.Tensor,
                            B: Optional[torch.Tensor], z: torch.Tensor, post: WPost,
                            k: int) -> torch.Tensor:
    """``rank1_col_dot`` with T18 of factor ``k`` in its finish: E += x ⊗ y
    (times B) in place, u = z @ E over the corrected E, then the posterior;
    the bits of ``rank1_col_dot`` then ``w_posterior``. ``y`` is the previous
    factor's δ; returns factor k's (on the card ``post``'s other buffer)."""
    if not on_card(E):
        return rank1_col_dot_posterior_plain(E, x, y, B, z, post, k)
    (n, d), head = _rank1_args(E, x, y, B)
    if d != post.d:
        raise ValueError(f"E has {d} columns where the weights have {post.d} rows")
    z_ptr, z_stride = _vector(z, n, "z", E.device, broadcast_ok=True)
    partial, done, u = _col_dot_scratch(E.device, n, d)
    args, delta = post.args(k)
    if delta.data_ptr() == y.data_ptr():
        raise ValueError(f"factor {k}'s δ buffer is y, which the pass reads")
    _kernels.launch("mofa_rank1_col_dot_posterior", E.device, *head, z_ptr, z_stride, n, d,
                    partial.data_ptr(), done.data_ptr(), u.data_ptr(), *args)
    return delta


def rank1_col_dot_posterior_plain(E: torch.Tensor, x: torch.Tensor, y: torch.Tensor,
                                  B: Optional[torch.Tensor], z: torch.Tensor, post: WPost,
                                  k: int) -> torch.Tensor:
    return post.plain(rank1_col_dot_plain(E, x, y, B, z), k)


# ---------------------------------------------------------------------------
# T19
# ---------------------------------------------------------------------------


def row_dot(E: torch.Tensor, t: torch.Tensor, B: Optional[torch.Tensor] = None,
            t1: Optional[torch.Tensor] = None, t2: Optional[torch.Tensor] = None):
    """T19: ``r (N,)`` with r[n] = Σ_d E[n, d]·t[d]. With a mask ``B``
    (N, D) also Σ_d B[n, d]·t1[d] and Σ_d B[n, d]·t2[d] from the same pass
    over the row: returns ``(r, pb, qb)``. ``t``, ``t1``, ``t2`` are (D,),
    t1 and t2 with one stride. Each row is summed by 32 lanes in column
    order and a butterfly: the same bits in every run."""
    if (B is None) != (t1 is None) or (B is None) != (t2 is None):
        raise ValueError("B, t1 and t2 come together")
    if not on_card(E):
        return row_dot_plain(E, t, B, t1, t2)
    dev = E.device
    n, d = _matrix(E, "E", dev)
    t_ptr, t_stride = _vector(t, d, "t", dev)
    r = torch.empty(n, dtype=torch.float32, device=dev)
    if B is None:
        _kernels.launch("mofa_row_dot", dev, E.data_ptr(), t_ptr, t_stride, 0, 0, 0, 0,
                        n, d, r.data_ptr(), 0, 0)
        return r
    _matrix(B, "B", dev, (n, d))
    t1_ptr, t1_stride = _vector(t1, d, "t1", dev)
    t2_ptr, t2_stride = _vector(t2, d, "t2", dev)
    if t1_stride != t2_stride:
        raise ValueError(f"t1 and t2 must share a stride, got {t1_stride} and {t2_stride}")
    pb, qb = torch.empty_like(r), torch.empty_like(r)
    _kernels.launch("mofa_row_dot", dev, E.data_ptr(), t_ptr, t_stride, B.data_ptr(),
                    t1_ptr, t2_ptr, t1_stride, n, d, r.data_ptr(), pb.data_ptr(),
                    qb.data_ptr())
    return r, pb, qb


def row_dot_plain(E: torch.Tensor, t: torch.Tensor, B: Optional[torch.Tensor] = None,
                  t1: Optional[torch.Tensor] = None, t2: Optional[torch.Tensor] = None):
    if B is None:
        return E @ t
    return E @ t, B @ t1, B @ t2


# ---------------------------------------------------------------------------
# T20
# ---------------------------------------------------------------------------


def rank1_update(E: torch.Tensor, x: torch.Tensor, y: torch.Tensor,
                 B: Optional[torch.Tensor] = None) -> torch.Tensor:
    """T20: E[n, d] += x[n]·y[d], times B[n, d] where masked, in place;
    returns E. ``x`` (N,) and ``y`` (D,) may be strided."""
    if not on_card(E):
        return rank1_update_plain(E, x, y, B)
    (n, d), args = _rank1_args(E, x, y, B)
    _kernels.launch("mofa_rank1_update", E.device, *args, n, d)
    return E


def rank1_update_plain(E: torch.Tensor, x: torch.Tensor, y: torch.Tensor,
                       B: Optional[torch.Tensor] = None) -> torch.Tensor:
    corr = x[:, None] * y[None, :]
    return E.add_(corr if B is None else corr * B)


def _rank1_args(E: torch.Tensor, x: torch.Tensor, y: torch.Tensor, B: Optional[torch.Tensor]):
    """T20's pointers and strides: E, x, x's stride, y, y's stride, B (0
    unmasked), after the checks of ``rank1_update``."""
    dev = E.device
    n, d = _matrix(E, "E", dev)
    x_ptr, x_stride = _vector(x, n, "x", dev)
    y_ptr, y_stride = _vector(y, d, "y", dev)
    if B is not None:
        _matrix(B, "B", dev, (n, d))
    return (n, d), (E.data_ptr(), x_ptr, x_stride, y_ptr, y_stride,
                    0 if B is None else B.data_ptr())


def rank1_col_dot(E: torch.Tensor, x: torch.Tensor, y: torch.Tensor,
                  B: Optional[torch.Tensor], z: torch.Tensor) -> torch.Tensor:
    """T20 then T17 in one pass over E: E[n, d] += x[n]·y[d] (times B[n, d]
    where masked) in place, then ``u (D,)`` with u[d] = Σ_n z[n]·E[n, d]
    over the corrected E. The same bits as ``rank1_update`` then
    ``col_dot``: the w sweep's correction of factor k with factor k + 1's
    reduction. ``z`` may be strided or a broadcast."""
    if not on_card(E):
        return rank1_col_dot_plain(E, x, y, B, z)
    (n, d), args = _rank1_args(E, x, y, B)
    z_ptr, z_stride = _vector(z, n, "z", E.device, broadcast_ok=True)
    partial, done, u = _col_dot_scratch(E.device, n, d)
    _kernels.launch("mofa_rank1_col_dot", E.device, *args, z_ptr, z_stride, n, d,
                    partial.data_ptr(), done.data_ptr(), u.data_ptr())
    return u


def rank1_col_dot_plain(E: torch.Tensor, x: torch.Tensor, y: torch.Tensor,
                        B: Optional[torch.Tensor], z: torch.Tensor) -> torch.Tensor:
    return col_dot_plain(rank1_update_plain(E, x, y, B), z)


def rank1_row_dot(E: torch.Tensor, x: torch.Tensor, y: torch.Tensor,
                  B: Optional[torch.Tensor], t: torch.Tensor,
                  t1: Optional[torch.Tensor] = None, t2: Optional[torch.Tensor] = None):
    """T20 then T19 in one pass over E: E[n, d] += x[n]·y[d] (times B[n, d]
    where masked) in place, then ``r (N,)`` with r[n] = Σ_d E[n, d]·t[d]
    over the corrected E; with the mask ``B`` also Σ_d B·t1 and Σ_d B·t2,
    returned as ``(r, pb, qb)``. The same bits as ``rank1_update`` then
    ``row_dot``: the z sweep's correction of factor k with factor k + 1's
    reduction."""
    if (B is None) != (t1 is None) or (B is None) != (t2 is None):
        raise ValueError("B, t1 and t2 come together")
    if not on_card(E):
        return rank1_row_dot_plain(E, x, y, B, t, t1, t2)
    dev = E.device
    (n, d), args = _rank1_args(E, x, y, B)
    t_ptr, t_stride = _vector(t, d, "t", dev)
    r = torch.empty(n, dtype=torch.float32, device=dev)
    if B is None:
        _kernels.launch("mofa_rank1_row_dot", dev, *args, t_ptr, t_stride, 0, 0, 0, n, d,
                        r.data_ptr(), 0, 0)
        return r
    t1_ptr, t1_stride = _vector(t1, d, "t1", dev)
    t2_ptr, t2_stride = _vector(t2, d, "t2", dev)
    if t1_stride != t2_stride:
        raise ValueError(f"t1 and t2 must share a stride, got {t1_stride} and {t2_stride}")
    pb, qb = torch.empty_like(r), torch.empty_like(r)
    _kernels.launch("mofa_rank1_row_dot", dev, *args, t_ptr, t_stride, t1_ptr, t2_ptr,
                    t1_stride, n, d, r.data_ptr(), pb.data_ptr(), qb.data_ptr())
    return r, pb, qb


def rank1_row_dot_plain(E: torch.Tensor, x: torch.Tensor, y: torch.Tensor,
                        B: Optional[torch.Tensor], t: torch.Tensor,
                        t1: Optional[torch.Tensor] = None, t2: Optional[torch.Tensor] = None):
    return row_dot_plain(rank1_update_plain(E, x, y, B), t, B, t1, t2)


# ---------------------------------------------------------------------------
# T23
# ---------------------------------------------------------------------------


def bound_refresh(lik: str, Zm: torch.Tensor, SW: torch.Tensor, Y0: torch.Tensor,
                  M01: Optional[torch.Tensor] = None, z2: Optional[torch.Tensor] = None,
                  SWW: Optional[torch.Tensor] = None, kappa: Optional[torch.Tensor] = None,
                  target: bool = False):
    """T23: the local bound of a bernoulli or poisson view, refreshed from
    the factors ``Zm`` (N, K) and the weights ``SW`` (D, K), with F = Zm SWᵀ:

    - bernoulli (Jaakkola; needs ``z2 = Zv + Zm²`` and ``SWW = E[(sŵ)²]``):
      ζ = √max(F² + Σₖ (z2·sww − zm²·sw²), 1e-10), λ = tanh(ζ/2)/(4ζ) (⅛
      where ζ ≤ 1e-4), T = 2λ·M01, E = (Y0 − ½M01) − T·F, target Y0 − ½M01;
    - poisson (Seeger; needs ``kappa`` (D,)): pseudo = F − σ(F)(1 − Y0 /
      max(softplus F, 1e-6))/κ, E = (pseudo − F)·M01, target pseudo·M01,
      and T is M01 itself.

    ``M01`` (N, D) is the 0/1 mask, None for all observed. Returns
    ``(E, T, target)``, the target None unless asked for (the stochastic
    sweep rebuilds its residuals from it)."""
    if lik not in ("bernoulli", "poisson"):
        raise ValueError(f"bound_refresh takes a bernoulli or poisson view, not {lik!r}")
    poisson = lik == "poisson"
    if (kappa is None) != (not poisson) or (not poisson and (z2 is None or SWW is None)):
        raise ValueError("bernoulli needs z2 and SWW, poisson needs kappa")
    if not on_card(Y0):
        return bound_refresh_plain(lik, Zm, SW, Y0, M01, z2, SWW, kappa, target)
    dev = Y0.device
    n, d = _matrix(Y0, "Y0", dev)
    n_z, K = _matrix(Zm, "Zm", dev)
    if n_z != n:
        raise ValueError(f"Zm has {n_z} rows where Y0 has {n}")
    _matrix(SW, "SW", dev, (d, K))
    if M01 is not None:
        _matrix(M01, "M01", dev, (n, d))
    if poisson:
        _vector(kappa, d, "kappa", dev)
        if d > 1 and kappa.stride(0) != 1:
            raise ValueError("kappa must be contiguous")
    else:
        _matrix(z2, "z2", dev, (n, K))
        _matrix(SWW, "SWW", dev, (d, K))
    E = torch.empty_like(Y0)
    T = M01 if poisson else torch.empty_like(Y0)
    tgt = torch.empty_like(Y0) if target else None

    def ptr(t):
        return 0 if t is None else t.data_ptr()

    _kernels.launch("mofa_bound_refresh", dev, Zm.data_ptr(), ptr(z2), SW.data_ptr(),
                    ptr(SWW), Y0.data_ptr(), ptr(M01), ptr(kappa), int(poisson), n, d, K,
                    E.data_ptr(), 0 if poisson else T.data_ptr(), ptr(tgt))
    return E, T, tgt


def bound_refresh_plain(lik: str, Zm: torch.Tensor, SW: torch.Tensor, Y0: torch.Tensor,
                        M01: Optional[torch.Tensor] = None, z2: Optional[torch.Tensor] = None,
                        SWW: Optional[torch.Tensor] = None,
                        kappa: Optional[torch.Tensor] = None, target: bool = False):
    """The reference's formulas, as three products and elementwise passes."""
    M = torch.ones_like(Y0) if M01 is None else M01
    F = Zm @ SW.T
    if lik == "bernoulli":
        e2 = F * F + z2 @ SWW.T - (Zm * Zm) @ (SW * SW).T
        zeta = torch.sqrt(torch.clamp(e2, min=1e-10))
        lam = torch.where(zeta > 1e-4, torch.tanh(zeta / 2.0) / (4.0 * zeta),
                          torch.full_like(zeta, 0.125))
        T = 2.0 * lam * M
        tgt = Y0 - 0.5 * M
        return tgt - T * F, T, (tgt if target else None)
    # softplus as jax writes it: max(x, 0) + log1p(exp(−|x|)), no threshold
    rate = torch.clamp(F, min=0.0) + torch.log1p(torch.exp(-F.abs()))
    pseudo = F - torch.sigmoid(F) * (1.0 - Y0 / torch.clamp(rate, min=1e-6)) / kappa[None, :]
    return (pseudo - F) * M, M01, (pseudo * M if target else None)
