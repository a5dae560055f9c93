"""Poseidon permutation over Goldilocks (width 12, 8 full + 22 partial rounds);
counterpart of olavm_tpu/hash/poseidon.py.

Three parts:
- the numpy host half, carried from olavm_tpu/hash/poseidon.py:75-240
  unchanged (trace generation, challenger, SMT hashing);
- a torch permutation over (12, n) states: on a CUDA tensor it launches K2
  (csrc/poseidon.cu, whose MDS constants are compiled in and checked against
  the tables here at its first use); on a CPU tensor it runs the plain version,
  `permute_plain`, which follows permute_stacked_gf_unrolled
  (olavm_tpu/hash/poseidon.py:417-468) with the plain field ops;
- the Poseidon Merkle hashing of merkle/device.py: `leaves` (the rate-8
  overwrite sponge over each leaf of a (C, n) column array) and `level` (one
  tree level of (8, n) digest words), and `absorb`, the leaf sponge over one
  block of columns from the states an earlier block left (the streamed
  commit of merkle/device.py LeafStream). On a CUDA tensor each launches its
  kernel in csrc/poseidon.cu (the sponge and the compression are in
  csrc/poseidon_merkle.cuh); on a CPU tensor each runs its plain version,
  `leaves_plain`, `level_plain` or `absorb_plain`, loops over
  `permute_plain`.

The round and MDS constants are read from poseidon_constants.json beside this
module, a copy of olavm_tpu/hash/poseidon_constants.json (required bit for
bit for proof compatibility).
"""

from __future__ import annotations

import json
from importlib.resources import files
from typing import Sequence

import numpy as np
import torch

from ..field import goldilocks as g

from .. import kernels
from ..field import gf

WIDTH = 12
RATE = 8
CAPACITY = 4
HALF_N_FULL_ROUNDS = 4
N_PARTIAL_ROUNDS = 22

_C = json.loads(
    files("olavm_tpu_torch.hash").joinpath("poseidon_constants.json").read_text())

ALL_ROUND_CONSTANTS = _C["ALL_ROUND_CONSTANTS"]  # 360
MDS_CIRC = _C["MDS_MATRIX_CIRC"]  # 12, small ints
MDS_DIAG = _C["MDS_MATRIX_DIAG"]  # 12, small ints
FAST_PARTIAL_FIRST_ROUND_CONSTANT = _C["FAST_PARTIAL_FIRST_ROUND_CONSTANT"]
FAST_PARTIAL_ROUND_CONSTANTS = _C["FAST_PARTIAL_ROUND_CONSTANTS"]
FAST_PARTIAL_ROUND_VS = _C["FAST_PARTIAL_ROUND_VS"]  # 22 x 11
FAST_PARTIAL_ROUND_W_HATS = _C["FAST_PARTIAL_ROUND_W_HATS"]  # 22 x 11
FAST_PARTIAL_ROUND_INITIAL_MATRIX = _C["FAST_PARTIAL_ROUND_INITIAL_MATRIX"]  # 11x11

_U64 = np.uint64

_NATIVE = None
_NATIVE_CHECKED = False


def _native():
    """Native host kernel module (the port's native/) if it loaded, else None."""
    global _NATIVE, _NATIVE_CHECKED
    if not _NATIVE_CHECKED:
        _NATIVE_CHECKED = True
        try:
            from .. import native

            if native.available:
                _NATIVE = native
        except Exception:
            _NATIVE = None
    return _NATIVE


# ---------------------------------------------------------------------------
# Host (numpy) version. States: uint64 array of shape (..., 12).
# ---------------------------------------------------------------------------


def _sbox_np(x):
    x2 = g.mul_arr(x, x)
    x4 = g.mul_arr(x2, x2)
    x3 = g.mul_arr(x, x2)
    return g.mul_arr(x3, x4)


def _constant_layer_np(state, round_ctr):
    for i in range(WIDTH):
        rc = _U64(ALL_ROUND_CONSTANTS[i + WIDTH * round_ctr])
        state[i] = g.add_arr(state[i], rc)


def _mds_layer_np(state):
    out = []
    for r in range(WIDTH):
        acc = np.zeros_like(state[0])
        for i in range(WIDTH):
            acc = g.add_arr(acc, g.mul_arr(state[(i + r) % WIDTH], _U64(MDS_CIRC[i])))
        acc = g.add_arr(acc, g.mul_arr(state[r], _U64(MDS_DIAG[r])))
        out.append(acc)
    return out


def _partial_first_constant_layer_np(state):
    for i in range(WIDTH):
        state[i] = g.add_arr(state[i], _U64(FAST_PARTIAL_FIRST_ROUND_CONSTANT[i]))


def _mds_partial_layer_init_np(state):
    out = [np.zeros_like(state[0]) for _ in range(WIDTH)]
    out[0] = state[0]
    for r in range(1, WIDTH):
        for c in range(1, WIDTH):
            t = _U64(FAST_PARTIAL_ROUND_INITIAL_MATRIX[r - 1][c - 1])
            out[c] = g.add_arr(out[c], g.mul_arr(state[r], t))
    return out


def _mds_partial_layer_fast_np(state, r):
    mds0to0 = _U64(MDS_CIRC[0] + MDS_DIAG[0])
    d = g.mul_arr(state[0], mds0to0)
    for i in range(1, WIDTH):
        d = g.add_arr(d, g.mul_arr(state[i], _U64(FAST_PARTIAL_ROUND_W_HATS[r][i - 1])))
    out = [None] * WIDTH
    out[0] = d
    for i in range(1, WIDTH):
        out[i] = g.add_arr(
            g.mul_arr(state[0], _U64(FAST_PARTIAL_ROUND_VS[r][i - 1])), state[i]
        )
    return out


def permute_np(states: np.ndarray, with_trace: bool = False):
    """Poseidon permutation; states shape (..., 12) uint64 canonical.

    With with_trace=True also returns a dict of intermediate states matching
    the reference PoseidonRow layout (core/src/trace/trace.rs:195-210):
    full_0_1/2/3 are post-constant-layer states of full rounds 1..3;
    partial[r] is the sbox input of partial round r; full_1_0..3 are
    post-constant-layer states of the second full rounds.
    """
    states = np.asarray(states, dtype=np.uint64)
    if not with_trace:
        native = _native()
        if native is not None:
            return native.permute_batch(states.reshape(-1, WIDTH)).reshape(
                states.shape
            )
    state = [states[..., i].copy() for i in range(WIDTH)]
    trace = {} if with_trace else None
    round_ctr = 0
    for r in range(HALF_N_FULL_ROUNDS):
        _constant_layer_np(state, round_ctr)
        if with_trace and r in (1, 2, 3):
            trace[f"full_0_{r}"] = np.stack(state, axis=-1)
        state = [_sbox_np(x) for x in state]
        state = _mds_layer_np(state)
        round_ctr += 1

    _partial_first_constant_layer_np(state)
    state = _mds_partial_layer_init_np(state)
    partials = []
    for r in range(N_PARTIAL_ROUNDS - 1):
        if with_trace:
            partials.append(state[0].copy())
        state[0] = _sbox_np(state[0])
        state[0] = g.add_arr(state[0], _U64(FAST_PARTIAL_ROUND_CONSTANTS[r]))
        state = _mds_partial_layer_fast_np(state, r)
    if with_trace:
        partials.append(state[0].copy())
    state[0] = _sbox_np(state[0])
    state = _mds_partial_layer_fast_np(state, N_PARTIAL_ROUNDS - 1)
    round_ctr += N_PARTIAL_ROUNDS

    for r in range(HALF_N_FULL_ROUNDS):
        _constant_layer_np(state, round_ctr)
        if with_trace:
            trace[f"full_1_{r}"] = np.stack(state, axis=-1)
        state = [_sbox_np(x) for x in state]
        state = _mds_layer_np(state)
        round_ctr += 1

    out = np.stack(state, axis=-1)
    if with_trace:
        trace["partial"] = np.stack(partials, axis=-1)
        return out, trace
    return out


def hash_n_to_m_no_pad(inputs: Sequence[int], num_outputs: int) -> list[int]:
    """plonky2 sponge (overwrite mode, rate 8); scalar host version.

    Reference: plonky2/plonky2/src/hash/hashing.rs:87-107.
    """
    state = np.zeros(WIDTH, dtype=np.uint64)
    inputs = [int(x) for x in inputs]
    for i in range(0, len(inputs), RATE):
        chunk = inputs[i : i + RATE]
        state[: len(chunk)] = np.array(chunk, dtype=np.uint64)
        state = permute_np(state)
    outputs = []
    while True:
        for x in state[:RATE]:
            outputs.append(int(x))
            if len(outputs) == num_outputs:
                return outputs
        state = permute_np(state)


def hash_no_pad(inputs: Sequence[int]) -> list[int]:
    return hash_n_to_m_no_pad(inputs, 4)


def two_to_one(x: Sequence[int], y: Sequence[int]) -> list[int]:
    """Merkle compression (plonky2 hashing.rs:66-74)."""
    state = np.zeros(WIDTH, dtype=np.uint64)
    state[0:4] = np.array([int(v) for v in x], dtype=np.uint64)
    state[4:8] = np.array([int(v) for v in y], dtype=np.uint64)
    return [int(v) for v in permute_np(state)[:4]]


def arbitrary_poseidon_np(inputs: Sequence[int], with_rows: bool = False):
    """Variable-length sponge used by the VM's POSEIDON opcode and program
    hashing (core/src/crypto/poseidon_trace.rs:67-185). Returns (hash4, rows)
    where rows capture every chunk's full PoseidonRow-compatible data."""
    state = np.zeros(WIDTH, dtype=np.uint64)
    rows = []
    inputs = [int(x) for x in inputs]
    for i in range(0, len(inputs), RATE):
        chunk = inputs[i : i + RATE]
        state[: len(chunk)] = np.array(chunk, dtype=np.uint64)
        if with_rows:
            inp = state.copy()
            out, tr = permute_np(state, with_trace=True)
            rows.append({"input": inp, "output": out, **tr})
            state = out.copy()
        else:
            state = permute_np(state)
    return [int(v) for v in state[:4]], rows


# ---------------------------------------------------------------------------
# Device (torch) version. State: int64 tensor of shape (12, n).
# ---------------------------------------------------------------------------


def _u64_table(vals) -> np.ndarray:
    # explicit dtype: np.array on python ints > 2^63 would go through float64
    return np.ascontiguousarray(np.asarray(vals, dtype=np.uint64))


def _kernel_tables():
    """Constant tables in the order gl_poseidon_init takes them."""
    return [_u64_table(t).reshape(-1) for t in (
        ALL_ROUND_CONSTANTS, MDS_CIRC, MDS_DIAG,
        FAST_PARTIAL_FIRST_ROUND_CONSTANT, FAST_PARTIAL_ROUND_CONSTANTS,
        FAST_PARTIAL_ROUND_VS, FAST_PARTIAL_ROUND_W_HATS,
        FAST_PARTIAL_ROUND_INITIAL_MATRIX)]


def edge_states() -> np.ndarray:
    """(7, 12) states at the ends of the kernel's reductions, for its checks:
    all words 0, p-1, 2^32-1, 2^32, the largest low limb under p; 0 and p-1
    alternating, in both phases."""
    p = g.P
    rows = [[w] * WIDTH for w in (0, p - 1, 2**32 - 1, 2**32, 0xFFFFFFFEFFFFFFFF)]
    rows += [[0, p - 1] * (WIDTH // 2), [p - 1, 0] * (WIDTH // 2)]
    return np.array(rows, dtype=np.uint64)


_KERNEL_READY: set = set()


def _poseidon_lib(device):
    lib = kernels.lib("poseidon")
    key = str(device)
    if key not in _KERNEL_READY:
        tables = _kernel_tables()
        with torch.cuda.device(device):
            rc = lib.gl_poseidon_init(*[t.ctypes.data for t in tables])
        if rc == -1:
            raise RuntimeError("poseidon init: the MDS tables differ from the "
                               "constants compiled into csrc/poseidon_perm.cuh")
        kernels.check(rc, "poseidon init")
        _KERNEL_READY.add(key)
    return lib


def _permute_cuda(state: torch.Tensor) -> torch.Tensor:
    state = state.contiguous()
    kernels.require_cuda_int64(state)
    out = torch.empty_like(state)
    n = state.shape[1]
    if n == 0:
        return out
    lib = _poseidon_lib(state.device)
    kernels.check(lib.gl_poseidon_permute(state.data_ptr(), out.data_ptr(), n,
                                          kernels.stream_ptr(state)),
                  "poseidon")
    kernels.count("poseidon")
    return out


def _col(vals, device) -> torch.Tensor:
    """(k,) constants -> (k, 1) int64 tensor (broadcasts over lanes)."""
    return gf.from_u64(_u64_table(vals), device).reshape(-1, 1)


def _sbox_plain(x):
    x2 = gf.mul_plain(x, x)
    x4 = gf.mul_plain(x2, x2)
    x3 = gf.mul_plain(x, x2)
    return gf.mul_plain(x3, x4)


def permute_plain(state: torch.Tensor) -> torch.Tensor:
    """Width-12 Poseidon over (12, n) states with the plain field ops."""
    dev = state.device
    rc = _col(ALL_ROUND_CONSTANTS, dev).reshape(30, WIDTH, 1)
    coef = np.array([[MDS_CIRC[(j - r) % WIDTH] for j in range(WIDTH)]
                     for r in range(WIDTH)], dtype=np.uint64)
    coef[np.arange(WIDTH), np.arange(WIDTH)] += np.asarray(MDS_DIAG, np.uint64)
    coef_t = gf.from_u64(coef, dev).reshape(WIDTH, WIDTH, 1)

    def full_round(st, r):
        st = _sbox_plain(gf.add_plain(st, rc[r]))
        # out[row] = sum_j coef[row, j] * st[j], all rows at once
        return gf.sum_rows_plain(gf.mul_plain(coef_t.transpose(0, 1), st[:, None]))

    for r in range(HALF_N_FULL_ROUNDS):
        state = full_round(state, r)
    state = gf.add_plain(state, _col(FAST_PARTIAL_FIRST_ROUND_CONSTANT, dev))
    init = _col(FAST_PARTIAL_ROUND_INITIAL_MATRIX, dev).reshape(
        WIDTH - 1, WIDTH - 1, 1)
    rest = gf.sum_rows_plain(gf.mul_plain(state[1:, None], init))
    s0 = state[0]
    prc = _col(FAST_PARTIAL_ROUND_CONSTANTS, dev)
    vs = _col(FAST_PARTIAL_ROUND_VS, dev).reshape(N_PARTIAL_ROUNDS, WIDTH - 1, 1)
    wh = _col(FAST_PARTIAL_ROUND_W_HATS, dev).reshape(
        N_PARTIAL_ROUNDS, WIDTH - 1, 1)
    mds0to0 = gf.scalar(MDS_CIRC[0] + MDS_DIAG[0], dev)
    for i in range(N_PARTIAL_ROUNDS):
        s0 = _sbox_plain(s0)
        if i < N_PARTIAL_ROUNDS - 1:
            s0 = gf.add_plain(s0, prc[i])
        d = gf.add_plain(gf.mul_plain(s0, mds0to0),
                         gf.sum_rows_plain(gf.mul_plain(rest, wh[i])))
        rest = gf.add_plain(gf.mul_plain(s0, vs[i]), rest)
        s0 = d
    state = torch.cat([s0[None], rest])
    for r in range(HALF_N_FULL_ROUNDS + N_PARTIAL_ROUNDS,
                   2 * HALF_N_FULL_ROUNDS + N_PARTIAL_ROUNDS):
        state = full_round(state, r)
    return state


def permute(state: torch.Tensor) -> torch.Tensor:
    """Batched permutation of (12, n) states: K2 on a CUDA tensor, the plain
    version on a CPU tensor."""
    if state.shape[0] != WIDTH:
        raise ValueError(f"expected (12, n) states, got {tuple(state.shape)}")
    if state.device.type == "cuda":
        return _permute_cuda(state)
    return permute_plain(state)


# ---------------------------------------------------------------------------
# Merkle hashing on torch tensors. A digest batch is (8, n) int64 holding u32
# words: element w of digest j is words 2w (low half) and 2w + 1 (high half)
# of column j, the layout of the blake3 digests (merkle/device.py).
# ---------------------------------------------------------------------------

DIGEST = 4  # elements per digest


def _digest_words(d: torch.Tensor) -> torch.Tensor:
    """(4, n) elements -> (8, n) u32 words (lo, hi per element)."""
    return torch.stack([d & gf.M32, (d >> 32) & gf.M32], dim=1).reshape(
        2 * d.shape[0], d.shape[1])


def leaves_plain(cols: torch.Tensor) -> torch.Tensor:
    """Plain version of the leaf kernel: hash_no_pad of each column of (C, n)
    canonical elements -> (8, n) digest words."""
    return absorb_plain(cols, None, True)


def absorb_plain(block: torch.Tensor, state, final: bool) -> torch.Tensor:
    """Plain version of the absorb kernel: the rate-8 overwrite sponge over
    the (W, n) block from the (12, n) states `state` (None: zero). A last
    chunk of k < 8 elements overwrites only words 0..k-1 of the state.
    Returns the states, or the (8, n) digest words if `final`."""
    W, n = block.shape
    if state is None:
        state = torch.zeros((WIDTH, n), dtype=torch.int64, device=block.device)
    for start in range(0, W, RATE):
        chunk = min(RATE, W - start)
        state = permute_plain(torch.cat([block[start:start + chunk],
                                         state[chunk:]]))
    return _digest_words(state[:DIGEST]) if final else state


def leaves(cols: torch.Tensor) -> torch.Tensor:
    """Poseidon digests of the n leaves of (C, n) columns, C >= 1 (whether a
    short leaf is its own digest is the caller's rule) -> (8, n) words: the
    leaf kernel on a CUDA tensor, the plain version on a CPU tensor."""
    C, n = cols.shape
    if C < 1:
        raise ValueError("a Poseidon leaf needs at least one element")
    if cols.device.type != "cuda":
        return leaves_plain(cols)
    kernels.require_cuda_int64(cols)
    out = torch.empty((8, n), dtype=torch.int64, device=cols.device)
    if n == 0:
        return out
    lib = _poseidon_lib(cols.device)
    kernels.check(lib.gl_poseidon_leaves(cols.data_ptr(), out.data_ptr(), n, C,
                                         kernels.stream_ptr(cols)),
                  "poseidon_leaves")
    kernels.count("poseidon_leaves")
    return out


def absorb(block: torch.Tensor, state, final: bool) -> torch.Tensor:
    """Absorb a (W, n) block of leaf columns, 1 <= W <= 16, into the (12, n)
    sponge states `state` (None: the leaves' first block, from zero): the
    streamed leaf sponge. Returns the new states (in `state` itself on the
    card), or the (8, n) digest words if `final` (the leaves' last block):
    gl_poseidon_absorb on a CUDA tensor, the plain version on a CPU tensor."""
    W, n = block.shape
    if not 1 <= W <= 16:
        raise ValueError(f"an absorbed block has 1 to 16 columns, got {W}")
    if block.device.type != "cuda":
        return absorb_plain(block, state, final)
    kernels.require_cuda_int64(block, *(() if state is None else (state,)))
    if final:
        out = torch.empty((8, n), dtype=torch.int64, device=block.device)
        state_out, digest_out = None, out.data_ptr()
    else:
        out = state if state is not None else torch.empty(
            (WIDTH, n), dtype=torch.int64, device=block.device)
        state_out, digest_out = out.data_ptr(), None
    lib = _poseidon_lib(block.device)
    kernels.check(lib.gl_poseidon_absorb(
        block.data_ptr(), None if state is None else state.data_ptr(),
        state_out, digest_out, n, W, kernels.stream_ptr(block)),
        "poseidon_absorb")
    kernels.count("poseidon_absorb")
    return out


def level_plain(digests: torch.Tensor) -> torch.Tensor:
    """Plain version of the level kernel: two_to_one of the digest pairs
    (2i, 2i + 1) of an (8, n) level -> (8, n / 2)."""
    d = digests[0::2] | (digests[1::2] << 32)
    left, right = d[:, 0::2], d[:, 1::2]
    state = torch.cat([left, right, torch.zeros_like(left)])
    return _digest_words(permute_plain(state)[:DIGEST])


def level(digests: torch.Tensor) -> torch.Tensor:
    """One Poseidon tree level: (8, n) digest words, n even -> (8, n / 2):
    the level kernel on a CUDA tensor, the plain version on a CPU tensor."""
    if digests.device.type != "cuda":
        return level_plain(digests)
    kernels.require_cuda_int64(digests)
    n = digests.shape[1]
    if digests.shape[0] != 8 or n < 2 or n % 2:
        raise ValueError(f"digest level must be (8, even n), got "
                         f"{tuple(digests.shape)}")
    if digests.data_ptr() % 16:
        raise ValueError("digest level must be 16-byte aligned")
    out = torch.empty((8, n // 2), dtype=torch.int64, device=digests.device)
    lib = _poseidon_lib(digests.device)
    kernels.check(lib.gl_poseidon_level(digests.data_ptr(), out.data_ptr(), n,
                                        kernels.stream_ptr(digests)),
                  "poseidon_level")
    kernels.count("poseidon_level")
    return out
