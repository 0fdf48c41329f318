"""Spiking RPN head through the hand-written CUDA kernels: the forward of
one FPN level (K1, with a training instance that saves what the backward
needs, and a pair instance for two images, K8) and the backward for the
weights (K7).

Replaces ``snn/pallas_rpn.py``: ``rpn_head_snn_pallas_apply`` with its
per-level ``_run_level`` (K1, ``csrc/rpn_head.cu``: one pass over the tap
weights for a chunk of 8 steps, ``wgmma``, TMA) and its paired
``_run_level_x2`` (K8: K1's kernel with the blocks of both images of a pair
in one cluster of four, sharing each weight stage; per image K1's bits), and
``rpn_head_snn_pallas_train_apply``, whose custom VJP ``_level_train`` runs
``_run_level`` forward and ``_run_level_bwd`` backward (K7,
``csrc/rpn_head_bwd.cu``). Here the training forward is K1 too: its
training instance also stores the per-step bf16 conv currents, the period
map and the spike sums (:class:`Saved`), and K7 starts from those instead
of replaying the conv: a sweep reruns the LIF from the currents and runs
the reverse SuperSpike sweep, writing dc over the currents in place, and a
spike-code GEMM on ``wgmma`` forms the weight gradient. With bf16 neuron
states (the reference's ``lif_dtype=bf16``, its ``--no-amp``) K1, its
training instance, K7 and K8 each have an instance of their own
(``bf16_states=True``): the LIF v and i rounded to bf16 after every
operation and the threshold bf16(0.1), forward, in K7's rerun and in its
surrogate.
:func:`rpn_level_plain`, :func:`rpn_level_x2_plain`,
:func:`rpn_level_bwd_plain` and :func:`rpn_level_bwd_from_saved_plain`
beside them are their plain PyTorch versions and follow the TPU kernels'
formulation: threshold-count encoder periods, the conv current rounded to
the plane dtype, f32 LIF states, an LI-weighted spike sum with
:func:`snnf.li_coefficients` and one fused readout after the loop, rounded
to the plane dtype; backwards, the decayed membranes of the forward (from a
replay of the conv, or from the saved currents), the reverse SuperSpike
sweep written out (no autograd) and the two weight-gradient products.

A CPU tensor takes the plain versions (bf16 or f32 planes); a CUDA tensor
launches the kernels, which take bf16 planes only, or raises.
:class:`RpnLevelTrain` ties K1's training instance and K7 into one
differentiable level.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch
import torch.nn.functional as F

from snn_automotive_object_detection_tpu_torch.snn import functional as snnf
from snn_automotive_object_detection_tpu_torch.utils import cuda_build as cb
from snn_automotive_object_detection_tpu_torch.utils.constants import device_constant

NAME = "rpn_head"
BWD_NAME = "rpn_head_bwd"
X2_NAME = "rpn_head_x2"
# The instances for bf16 neuron states, each with its own launch counter:
# K1's evaluation and training instances, K7's and K8's.
S16_NAME = "rpn_head_s16"
S16_SAVE_NAME = "rpn_head_s16_save"
BWD_S16_NAME = "rpn_head_bwd_s16"
X2_S16_NAME = "rpn_head_x2_s16"
# Whether the head outside training takes the paired kernel for the levels
# that can pair (see :func:`x2_feasible`) when no rates are collected.
# ``chip_smoke.check_rpn_x2`` times K8 against K1 in turns on the five
# flagship levels in every run. Off: K8 gives K1's bits but takes 6.8-6.9
# ms for them on an H100 against K1's 5.6-5.8 (PERF.md).
PAIR_IMAGES = False
# Split counts of K7's pixel range: the weight gradient's 18 blocks per
# split (9 taps x 2 input-channel tiles) times 7 are one wave on 132 SMs;
# dwout's 264 blocks of 256 threads are two for each SM.
DW9_SPLITS = 7
DWOUT_SPLITS = 264
MAX_T = 32
MAX_OUT = 128


class Saved(NamedTuple):
    """What the training forward of a level keeps for its backward:
    the conv currents as the LIF took them, cur [N, H, W, T, C] in the
    plane dtype; the encoder periods, per [N, H, W, C] uint8 (T + 1: no
    spike within T steps); the LI-weighted spike sums, ssum [N, H, W, C]
    f32."""
    cur: torch.Tensor
    per: torch.Tensor
    ssum: torch.Tensor


def _constants(num_steps: int, device) -> torch.Tensor:
    """[2T] float32 on ``device``: the encoder thresholds, then the LI
    coefficients."""
    return device_constant(tuple(snnf.encoder_thresholds(num_steps).tolist())
                           + tuple(snnf.li_coefficients(num_steps).tolist()),
                           torch.float32, device)


def _taps_t(w_shared: torch.Tensor) -> torch.Tensor:
    """[3, 3, C, C] HWIO -> [9, C, C] bf16, dy-major, [output, input]
    channels per tap: K1 and K8 read each tap's rows by TMA as the K-major
    B of their products. One copy, as the cast to bf16 alone would be."""
    c = w_shared.shape[2]
    return w_shared.reshape(9, c, c).transpose(1, 2).to(torch.bfloat16).contiguous()


def _level_steps(feat: torch.Tensor, w_shared: torch.Tensor,
                 w_out: torch.Tensor, num_steps: int, save: bool = False,
                 bf16_states: bool = False):
    """The T steps of one level on a batch of images: (readout, encoder
    counts, LIF spike counts, LI-weighted spike sums, and with ``save`` the
    :class:`Saved` tensors, else None). ``bf16_states`` carries the LIF v
    and i in bf16 (see :func:`rpn_level_plain`)."""
    cd = feat.dtype
    n, h, w, c = feat.shape
    consts = _constants(num_steps, feat.device)
    thr, li = consts[:num_steps], consts[num_steps:]
    periods = snnf.threshold_periods(feat.float(), thr)
    weight = w_shared.to(cd).permute(3, 2, 0, 1).contiguous()
    sd = torch.bfloat16 if bf16_states else torch.float32
    state = snnf.zeros_lif_state((n, h, w, c), sd, feat.device)
    ssum = torch.zeros((n, h, w, c), dtype=torch.float32, device=feat.device)
    enc = torch.zeros(n, dtype=torch.int64, device=feat.device)
    lif = torch.zeros(n, dtype=torch.int64, device=feat.device)
    curs = []
    for t in range(num_steps):
        z = snnf.encoder_spikes_at(periods, t, cd)
        cur = F.conv2d(z.permute(0, 3, 1, 2), weight, padding=1).permute(0, 2, 3, 1)
        if save:
            curs.append(cur)
        s, state = snnf.lif_feed_forward_step(cur.to(sd), state)
        s = s.float()
        ssum = ssum + li[t] * s
        enc += z.sum(dim=(1, 2, 3), dtype=torch.int64)
        lif += s.sum(dim=(1, 2, 3), dtype=torch.int64)
    out = torch.matmul(ssum, w_out.to(cd).float()).to(cd).float()
    saved = Saved(torch.stack(curs, dim=3), periods.to(torch.uint8), ssum) if save else None
    return out, enc, lif, ssum, saved


# K1's instances by (save, bf16_states): (launch counter, C entry).
_LEVEL = {(False, False): (NAME, "rpn_level_bf16"),
          (True, False): (NAME, "rpn_level_save_bf16"),
          (False, True): (S16_NAME, "rpn_level_s16_bf16"),
          (True, True): (S16_SAVE_NAME, "rpn_level_save_s16_bf16")}


def _returns(got, spike_sum: bool, save: bool):
    """(readout, encoder counts, LIF counts) from ``got`` = (those, spike
    sums, saved), then the spike sums with ``spike_sum``, then the saved
    tensors with ``save``."""
    return got[:3] + ((got[3],) if spike_sum else ()) + ((got[4],) if save else ())


def rpn_level_plain(feat: torch.Tensor, w_shared: torch.Tensor,
                    w_out: torch.Tensor, num_steps: int, spike_sum: bool = False,
                    save: bool = False, bf16_states: bool = False):
    """One FPN level, plain PyTorch.

    feat [N, H, W, C] in the plane dtype (bf16 or f32); w_shared
    [3, 3, C, C] HWIO; w_out [C, n_out]. Returns (readout [N, H, W, n_out]
    float32 holding plane-dtype values, encoder counts [N] int64, LIF spike
    counts [N] int64); with ``spike_sum`` also the LI-weighted spike sum
    [N, H, W, C] f32 of every neuron, for checks that count flipped spikes
    neuron by neuron; with ``save`` last the :class:`Saved` tensors that
    :func:`rpn_level_bwd_from_saved_plain` starts from (the currents rounded
    to the plane dtype, as the LIF takes them).

    ``bf16_states``: the plain version of K1's instance for bf16 neuron
    states (the reference's ``_run_level`` with ``lif_dtype=bf16``): the LIF
    v and i are bf16, every elementwise result is rounded to bf16 and the
    constants 0.1, 0.2 and the threshold are bf16 values
    (``snnf.lif_feed_forward_step`` on bf16 states). That is the program as
    the reference writes it, each jnp operation on bf16 arrays rounded to
    bf16, and what PyTorch's eager bf16 operations give; XLA on the CPU may
    keep f32 between fused operations where it allows excess precision,
    which tests/test_torch_state16.py measures. The currents are rounded to
    bf16 first and the LI-weighted spike sum stays f32; with ``save`` it is
    the plain version of K1's training instance with bf16 states, which
    saves what the f32-state one saves.
    """
    cb.note_plain(_LEVEL[save, bf16_states][0], feat)
    return _returns(_level_steps(feat, w_shared, w_out, num_steps, save, bf16_states),
                    spike_sum, save)


def level_grid(feat_shape, pair: bool = False):
    """The launch of K1 (or with ``pair`` its pair instance, K8) on a level
    [N, H, W, C], as ``level_grid`` in csrc/rpn_head.cu makes it
    (:func:`launch_dims_on_card` asks the C side): (grid, cluster dims),
    each (x, y, z). A block owns 16 pixels of a row; a
    cluster is two consecutive rows, and for the pair also the two images
    2p and 2p + 1, so the rows are padded to an even count (padded rows
    store nothing) and the pair needs an even batch."""
    n, h, w, _ = feat_shape
    cluster = (1, 2, 2 if pair else 1)
    return (-(-w // 16), -(-h // 2) * 2, n), cluster


def launch_dims_on_card(feat_shape, pair: bool = False):
    """:func:`level_grid` as the C side computes it for its launch."""
    n, h, w, _ = feat_shape
    dims = (ctypes.c_int * 6)()
    fn = cb.function(NAME, "rpn_level_launch_dims", [ctypes.c_int] * 4 + [ctypes.c_void_p])
    cb.check(fn(int(pair), n, h, w, ctypes.addressof(dims)), NAME)
    return tuple(dims[:3]), tuple(dims[3:])


def x2_feasible(feat_shape) -> bool:
    """Whether a level [N, H, W, C] can take the paired kernel: 256-channel
    planes of an even batch, whose grid (:func:`level_grid`) the card can
    launch. The kernel's shared memory does not depend on the level."""
    (_, gy, gz), (_, _, cz) = level_grid(feat_shape, pair=True)
    return feat_shape[3] == 256 and gz > 0 and gz % cz == 0 and gy <= 65535 and gz <= 65535


def rpn_level_x2_plain(feat: torch.Tensor, w_shared: torch.Tensor,
                       w_out: torch.Tensor, num_steps: int,
                       spike_sum: bool = False, bf16_states: bool = False):
    """One FPN level pair by pair, plain PyTorch: images 2p and 2p + 1 go
    through the steps together. feat [N, H, W, C] with N even. Returns the
    readout [N, H, W, n_out] f32, with ``spike_sum`` (readout, spike sums
    [N, H, W, C] f32); no spike counts. Per image the values are
    :func:`rpn_level_plain`'s, with ``bf16_states`` those of its bf16-state
    version."""
    cb.note_plain(X2_S16_NAME if bf16_states else X2_NAME, feat)
    if feat.shape[0] % 2:
        raise ValueError(f"the paired level takes an even batch, got {feat.shape[0]}")
    pairs = [_level_steps(feat[p:p + 2], w_shared, w_out, num_steps, bf16_states=bf16_states)
             for p in range(0, feat.shape[0], 2)]
    out = torch.cat([p[0] for p in pairs])
    return (out, torch.cat([p[3] for p in pairs])) if spike_sum else out


def _check_level(name, feat, w9, w_out, num_steps):
    n, h, w, c = feat.shape
    n_out = w_out.shape[1]
    cb.require(feat, "feat", torch.bfloat16)
    if c != 256:
        raise ValueError(f"{name} kernel takes 256 channels, got {c}")
    cb.require(w9, "w9", torch.bfloat16, (9, c, c))
    cb.require(w_out, "w_out", torch.bfloat16, (c, n_out))
    if not 1 <= num_steps <= MAX_T or not 1 <= n_out <= MAX_OUT:
        raise ValueError(f"{name} kernel takes T <= {MAX_T} and at most "
                         f"{MAX_OUT} readout channels")


def _launch(feat: torch.Tensor, w9_t: torch.Tensor, w_out: torch.Tensor,
            num_steps: int, spike_sum: bool = False, save: bool = False,
            bf16_states: bool = False):
    """K1 on one level, its training instance with ``save``, its instances
    for bf16 neuron states with ``bf16_states``; ``w9_t`` from
    :func:`_taps_t`. Same returns as :func:`rpn_level_plain`."""
    n, h, w, c = feat.shape
    n_out = w_out.shape[1]
    name, entry = _LEVEL[save, bf16_states]
    _check_level(name, feat, w9_t, w_out, num_steps)
    dev = feat.device
    consts = _constants(num_steps, dev)
    out = torch.empty((n, h, w, n_out), dtype=torch.float32, device=dev)
    counts = torch.zeros((n, 2), dtype=torch.int64, device=dev)
    ssum = (torch.empty((n, h, w, c), dtype=torch.float32, device=dev)
            if spike_sum or save else None)
    args = [feat.data_ptr(), w9_t.data_ptr(), w_out.data_ptr(), consts.data_ptr(),
            out.data_ptr(), counts.data_ptr(), None if ssum is None else ssum.data_ptr()]
    saved = None
    if save:
        saved = Saved(torch.empty((n, h, w, num_steps, c), dtype=torch.bfloat16, device=dev),
                      torch.empty((n, h, w, c), dtype=torch.uint8, device=dev), ssum)
        args += [saved.cur.data_ptr(), saved.per.data_ptr()]
    fn = cb.function(name, entry,
                     [ctypes.c_void_p] * len(args) + [ctypes.c_int] * 5 + [ctypes.c_void_p])
    code = fn(*args, n, h, w, num_steps, n_out, cb.stream_ptr(dev))
    cb.check(code, name)
    cb.LAUNCHES[name] += 1
    return _returns((out, counts[:, 0], counts[:, 1], ssum, saved), spike_sum, save)


def _launch_x2(feat: torch.Tensor, w9_t: torch.Tensor, w_out: torch.Tensor,
               num_steps: int, spike_sum: bool = False, bf16_states: bool = False):
    """K8 on one level, its instance for bf16 neuron states with
    ``bf16_states``; ``w9_t`` from :func:`_taps_t`. Same returns as
    :func:`rpn_level_x2_plain`."""
    n, h, w, c = feat.shape
    n_out = w_out.shape[1]
    name = X2_S16_NAME if bf16_states else X2_NAME
    _check_level(name, feat, w9_t, w_out, num_steps)
    if not x2_feasible(feat.shape):
        raise ValueError(f"{name} kernel takes an even batch, got {n}")
    consts = _constants(num_steps, feat.device)
    out = torch.empty((n, h, w, n_out), dtype=torch.float32, device=feat.device)
    ssum = (torch.empty((n, h, w, c), dtype=torch.float32, device=feat.device)
            if spike_sum else None)
    fn = cb.function(name, "rpn_level_x2_s16_bf16" if bf16_states else "rpn_level_x2_bf16",
                     [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5 + [ctypes.c_void_p])
    code = fn(feat.data_ptr(), w9_t.data_ptr(), w_out.data_ptr(), consts.data_ptr(),
              out.data_ptr(), None if ssum is None else ssum.data_ptr(), n, h, w,
              num_steps, n_out, cb.stream_ptr(feat.device))
    cb.check(code, name)
    cb.LAUNCHES[name] += 1
    return (out, ssum) if spike_sum else out


def rpn_level(feat: torch.Tensor, w_shared: torch.Tensor, w_out: torch.Tensor,
              num_steps: int, spike_sum: bool = False, save: bool = False,
              bf16_states: bool = False):
    """One level through K1 (CUDA; its training instance with ``save``, its
    instance for bf16 neuron states with ``bf16_states``) or the plain
    version (CPU). Same returns as :func:`rpn_level_plain`."""
    if cb.dispatch_device(feat, _LEVEL[save, bf16_states][0]):
        return _launch(feat, _taps_t(w_shared), w_out.to(torch.bfloat16).contiguous(),
                       num_steps, spike_sum, save, bf16_states)
    return rpn_level_plain(feat, w_shared, w_out, num_steps, spike_sum, save, bf16_states)


def rpn_level_x2(feat: torch.Tensor, w_shared: torch.Tensor, w_out: torch.Tensor,
                 num_steps: int, spike_sum: bool = False, bf16_states: bool = False):
    """One level pair by pair through the paired kernel (CUDA; its instance
    for bf16 neuron states with ``bf16_states``) or its plain version
    (CPU). Same returns as :func:`rpn_level_x2_plain`."""
    if cb.dispatch_device(feat, X2_S16_NAME if bf16_states else X2_NAME):
        return _launch_x2(feat, _taps_t(w_shared), w_out.to(torch.bfloat16).contiguous(),
                          num_steps, spike_sum, bf16_states)
    return rpn_level_x2_plain(feat, w_shared, w_out, num_steps, spike_sum, bf16_states)


def _decayed(state) -> torch.Tensor:
    """The decayed membrane a LIF step takes its spike on, in the state's
    dtype, by the operations of ``snnf.lif_feed_forward_step``."""
    p = snnf.LIF_PARAMS
    return state.v + snnf._weak(snnf.DT * p.tau_mem_inv, state.v) * (
        (p.v_leak - state.v) + state.i)


def _reverse_sweep(vds, periods: torch.Tensor, w_out: torch.Tensor, g: torch.Tensor,
                   li: torch.Tensor, cd: torch.dtype) -> torch.Tensor:
    """The reverse SuperSpike sweep of one level from the forward's decayed
    membranes ``vds`` (T tensors [N, H, W, C] in the state dtype) and
    encoder periods [N, H, W, C], with the cotangent g [N, H, W, n_out]: the
    3x3 conv's weight gradient [3, 3, C, C] f32. The threshold takes the
    state dtype, as the reference's kernel rounds it (bf16(0.1) with bf16
    states); the sweep itself is f32."""
    n, h, w, c = periods.shape
    p = snnf.LIF_PARAMS
    tau_mem, tau_syn = snnf.DT * p.tau_mem_inv, snnf.DT * p.tau_syn_inv
    # Only gw sees the cotangent rounded to the plane dtype: gw =
    # bf16(g) @ wout^T summed over the readout channels in order, each
    # product and each add rounded to f32, as the kernel sums it.
    g_cd, wo_cd = g.float().to(cd).float(), w_out.to(cd).float()
    gw = torch.zeros((n, h, w, c), dtype=torch.float32, device=periods.device)
    for j in range(w_out.shape[1]):
        gw = gw + g_cd[..., j:j + 1] * wo_cd[:, j]
    lv = torch.zeros_like(gw)
    lam = torch.zeros_like(gw)
    # The products of dw9 are exact (0/1 spikes times plane-dtype values);
    # summed in f64, so that this version's own sums over up to a million
    # pixels and steps carry no f32 rounding of their own.
    dw9 = torch.zeros((9, c, c), dtype=torch.float64, device=periods.device)
    for t in reversed(range(len(vds))):
        z = snnf.encoder_spikes_at(periods, t, cd).double()
        zp = F.pad(z, (0, 0, 1, 1, 1, 1))
        dc = lam.to(cd).double().reshape(-1, c)      # lam before this step's update
        for k in range(9):
            dy, dx = divmod(k, 3)
            dw9[k] += torch.matmul(
                zp[:, dy:dy + h, dx:dx + w].reshape(-1, c).t(), dc)
        vd = vds[t].float()
        u = vd - snnf._weak(p.v_th, vds[t])
        sp = 1.0 / (p.alpha * u.abs() + 1.0) ** 2    # SuperSpike
        ds = li[t] * gw - vd * lv
        dvd = (1.0 - (u > 0).float()) * lv + ds * sp
        lv = (1.0 - tau_mem) * dvd
        lam = tau_mem * dvd + (1.0 - tau_syn) * lam
    return dw9.float().reshape(3, 3, c, c)


def rpn_level_bwd_plain(feat: torch.Tensor, w_shared: torch.Tensor,
                        w_out: torch.Tensor, g: torch.Tensor, num_steps: int,
                        spike_sum: bool = False, bf16_states: bool = False):
    """Backward of one level for its weights, plain PyTorch, written out
    step by step (no autograd), replaying the forward's conv.

    feat [N, H, W, C] in the plane dtype (bf16 or f32); w_shared
    [3, 3, C, C]; w_out [C, n_out]; g [N, H, W, n_out] f32, the cotangent
    of the readout. Returns (dw_shared [3, 3, C, C] f32, dw_out [C, n_out]
    f32), and with ``spike_sum`` also the replay's LI-weighted spike sum
    [N, H, W, C] f32, which must equal the forward's. ``bf16_states``: the
    replay's LIF runs with bf16 states, as the reference's backward kernel
    with ``lif_dtype=bf16`` does, and the surrogate takes v_th = bf16(0.1).
    """
    cb.note_plain(BWD_S16_NAME if bf16_states else BWD_NAME, feat)
    sd = torch.bfloat16 if bf16_states else torch.float32
    cd = feat.dtype
    n, h, w, c = feat.shape
    consts = _constants(num_steps, feat.device)
    thr, li = consts[:num_steps], consts[num_steps:]
    periods = snnf.threshold_periods(feat.float(), thr)
    weight = w_shared.to(cd).permute(3, 2, 0, 1).contiguous()

    # Replay of the forward, keeping each step's decayed membrane.
    state = snnf.zeros_lif_state((n, h, w, c), sd, feat.device)
    ssum = torch.zeros((n, h, w, c), dtype=torch.float32, device=feat.device)
    vds = []
    for t in range(num_steps):
        z = snnf.encoder_spikes_at(periods, t, cd)
        cur = F.conv2d(z.permute(0, 3, 1, 2), weight, padding=1)
        cur = cur.permute(0, 2, 3, 1).to(sd)
        vds.append(_decayed(state))
        s, state = snnf.lif_feed_forward_step(cur, state)
        ssum = ssum + li[t] * s.float()
    dw_shared = _reverse_sweep(vds, periods, w_out, g, li, cd)
    dw_out = dwout_plain(ssum, g)
    return (dw_shared, dw_out, ssum) if spike_sum else (dw_shared, dw_out)


def rpn_level_bwd_from_saved_plain(saved: Saved, w_out: torch.Tensor, g: torch.Tensor,
                                   num_steps: int, spike_sum: bool = False,
                                   bf16_states: bool = False):
    """The plain version of K7: backward of one level for its weights from
    what the training forward saved (:class:`Saved`, from
    :func:`rpn_level_plain` with ``save``), with no replay of the conv: the
    LIF rerun from the saved currents gives the decayed membranes, then the
    reverse sweep and the two products. Same returns as
    :func:`rpn_level_bwd_plain` (the spike sums are the rerun's), and the
    same bits where the saved tensors are that function's forward's. The
    saved tensors are left as they are. ``bf16_states``: the plain version
    of K7's bf16-state instance (the rerun with bf16 states, the threshold
    bf16(0.1)), on what the bf16-state training forward saved."""
    cb.note_plain(BWD_S16_NAME if bf16_states else BWD_NAME, saved.cur)
    sd = torch.bfloat16 if bf16_states else torch.float32
    n, h, w, t, c = saved.cur.shape
    li = _constants(num_steps, saved.cur.device)[num_steps:]
    state = snnf.zeros_lif_state((n, h, w, c), sd, saved.cur.device)
    ssum = torch.zeros((n, h, w, c), dtype=torch.float32, device=saved.cur.device)
    vds = []
    for step in range(num_steps):
        vds.append(_decayed(state))
        s, state = snnf.lif_feed_forward_step(saved.cur[..., step, :].to(sd), state)
        ssum = ssum + li[step] * s.float()
    dw_shared = _reverse_sweep(vds, saved.per.int(), w_out, g, li, saved.cur.dtype)
    dw_out = dwout_plain(saved.ssum, g)
    return (dw_shared, dw_out, ssum) if spike_sum else (dw_shared, dw_out)


def dwout_plain(ssum: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """The readout's weight gradient ssum^T @ g, [C, n_out] f32, from the
    LI-weighted spike sums [N, H, W, C] and the f32 cotangent. It is linear
    in the spike sums, so a check can hold K7's ``dw_out`` against this
    product of the forward kernel's own sums where the kernel and its plain
    version differ in a spike."""
    c = ssum.shape[-1]
    return torch.matmul(ssum.reshape(-1, c).t(), g.float().reshape(-1, g.shape[-1]))


def _splits(n_chunks: int, target: int) -> int:
    """At most ``target`` splits of ``n_chunks`` chunks, none of them empty."""
    per = -(-n_chunks // target)
    return -(-n_chunks // per)


def _padded_steps(num_steps: int) -> int:
    """Steps per pixel in K7's weight-gradient GEMM: T padded to 8, 16 or 32,
    so that a stage of 64 GEMM rows holds whole pixels."""
    return 8 if num_steps <= 8 else 16 if num_steps <= 16 else 32


def _launch_bwd(saved: Saved, w_out: torch.Tensor, g: torch.Tensor, num_steps: int,
                spike_sum: bool = False, phases: int = 7, bf16_states: bool = False):
    """K7 on one level from K1's saved tensors (with ``bf16_states`` its
    bf16-state instance, on what K1's bf16-state training instance saved);
    ``w_out`` bf16. The sweep writes dc over ``saved.cur`` IN PLACE.
    Returns (dw9 [9, C, C] f32, dw_out [C, n_out] f32) and with
    ``spike_sum`` the sweep's own spike sums (equal to ``saved.ssum``).
    ``phases`` picks the kernels (bit 0 the sweep, bit 1 dw9, bit 2 dwout)
    for timings; 7 is the backward."""
    name = BWD_S16_NAME if bf16_states else BWD_NAME
    n, h, w, t, c = saved.cur.shape
    n_out = w_out.shape[1]
    cb.require(saved.cur, "cur", torch.bfloat16, (n, h, w, num_steps, 256))
    cb.require(saved.per, "per", torch.uint8, (n, h, w, c))
    cb.require(saved.ssum, "ssum", torch.float32, (n, h, w, c))
    cb.require(w_out, "w_out", torch.bfloat16, (c, n_out))
    cb.require(g, "g", torch.float32, (n, h, w, n_out))
    if not 1 <= num_steps <= MAX_T or not 1 <= n_out <= MAX_OUT:
        raise ValueError(f"{name} kernel takes T <= {MAX_T} and at most "
                         f"{MAX_OUT} readout channels")
    dev = saved.cur.device
    f32 = torch.float32
    px = 64 // _padded_steps(num_steps)
    s9 = _splits(n * h * (-(-w // px)), DW9_SPLITS)
    s_out = _splits(n * h * w, DWOUT_SPLITS)
    part9 = torch.empty((s9 if s9 > 1 else 0, 9, c, c), dtype=f32, device=dev)
    part_out = torch.empty((s_out, c, n_out), dtype=f32, device=dev)
    counters = torch.zeros(18, dtype=torch.int32, device=dev)
    dw9 = torch.empty((9, c, c), dtype=f32, device=dev)
    dw_out = torch.empty((c, n_out), dtype=f32, device=dev)
    swept = torch.empty((n, h, w, c), dtype=f32, device=dev) if spike_sum else None
    consts = _constants(num_steps, dev)
    fn = cb.function(name, "rpn_level_bwd_s16_bf16" if bf16_states else "rpn_level_bwd_bf16",
                     [ctypes.c_void_p] * 12 + [ctypes.c_int] * 8 + [ctypes.c_void_p])
    code = fn(saved.cur.data_ptr(), saved.per.data_ptr(), saved.ssum.data_ptr(),
              w_out.data_ptr(), consts.data_ptr(), g.data_ptr(),
              None if swept is None else swept.data_ptr(), part9.data_ptr(),
              part_out.data_ptr(), counters.data_ptr(), dw9.data_ptr(), dw_out.data_ptr(),
              n, h, w, num_steps, n_out, s9, s_out, phases, cb.stream_ptr(dev))
    cb.check(code, name)
    cb.LAUNCHES[name] += 1
    return (dw9, dw_out, swept) if spike_sum else (dw9, dw_out)


def rpn_level_bwd_from_saved(saved: Saved, w_out: torch.Tensor, g: torch.Tensor,
                             num_steps: int, spike_sum: bool = False,
                             bf16_states: bool = False):
    """Weight gradients of one level from the training forward's saved
    tensors: K7 (CUDA; it overwrites ``saved.cur`` with dc) or
    :func:`rpn_level_bwd_from_saved_plain` (CPU), each with bf16 states
    with ``bf16_states``. Same returns as :func:`rpn_level_bwd_plain`."""
    if cb.dispatch_device(saved.cur, BWD_S16_NAME if bf16_states else BWD_NAME):
        got = _launch_bwd(saved, w_out.to(torch.bfloat16).contiguous(),
                          g.float().contiguous(), num_steps, spike_sum,
                          bf16_states=bf16_states)
        c = saved.cur.shape[-1]
        return (got[0].reshape(3, 3, c, c),) + got[1:]
    return rpn_level_bwd_from_saved_plain(saved, w_out, g, num_steps, spike_sum, bf16_states)


def rpn_level_bwd(feat: torch.Tensor, w_shared: torch.Tensor, w_out: torch.Tensor,
                  g: torch.Tensor, num_steps: int, spike_sum: bool = False,
                  bf16_states: bool = False):
    """Weight gradients of one level: K1's training instance, then K7 on
    what it saved (CUDA), or the replaying plain version (CPU), each with
    bf16 states with ``bf16_states``. Same returns as
    :func:`rpn_level_bwd_plain`; on CUDA the spike sums are K7's sweep's."""
    if cb.dispatch_device(feat, BWD_S16_NAME if bf16_states else BWD_NAME):
        *_, saved = rpn_level(feat, w_shared, w_out, num_steps, save=True,
                              bf16_states=bf16_states)
        return rpn_level_bwd_from_saved(saved, w_out, g, num_steps, spike_sum, bf16_states)
    return rpn_level_bwd_plain(feat, w_shared, w_out, g, num_steps, spike_sum, bf16_states)


class RpnLevelTrain(torch.autograd.Function):
    """One differentiable level: forward is :func:`rpn_level` with ``save``
    (K1's training instance on a CUDA tensor), backward
    :func:`rpn_level_bwd_from_saved` (K7) on the tensors it saved: the
    currents, the period map and the spike sums, not the features; with
    ``bf16_states`` both their bf16-state instances. K7 overwrites the saved
    currents, so the backward runs once. The features get no gradient: the
    backbone is frozen wherever this route is taken."""

    @staticmethod
    def forward(ctx, feat, w_shared, w_out, num_steps, bf16_states=False):
        out, enc, lif, saved = rpn_level(feat, w_shared, w_out, num_steps, save=True,
                                         bf16_states=bf16_states)
        ctx.save_for_backward(*saved, w_out)
        ctx.num_steps = num_steps
        ctx.bf16_states = bf16_states
        ctx.w_shape, ctx.w_dtype = w_shared.shape, w_shared.dtype
        ctx.spent = False
        ctx.mark_non_differentiable(enc, lif)
        return out, enc, lif

    @staticmethod
    def backward(ctx, g_out, _g_enc, _g_lif):
        if ctx.spent:
            raise RuntimeError("RpnLevelTrain's backward runs once: K7 writes over "
                               "the saved currents")
        ctx.spent = True
        cur, per, ssum, w_out = ctx.saved_tensors
        dw_shared, dw_out = rpn_level_bwd_from_saved(Saved(cur, per, ssum), w_out, g_out,
                                                     ctx.num_steps, bf16_states=ctx.bf16_states)
        return (None, dw_shared.reshape(ctx.w_shape).to(ctx.w_dtype), dw_out.to(w_out.dtype),
                None, None)
