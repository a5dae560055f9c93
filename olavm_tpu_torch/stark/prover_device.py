"""Multi-table STARK prover on the card; counterpart of
olavm_tpu/stark/prover_device.py.

Same transcript as the host prover (circuits/src/stark/prover.rs): the
Fiat-Shamir challenger and proof objects stay on the host, every O(n) step
runs on the given torch device.

  commit    = iNTT -> per 16-column block: coset LDE -> absorb into the
              blake3 or Poseidon leaf states -> Merkle levels (oracle_device;
              only the coefficients and the tree stay resident)
  Z polys   = log-depth grand products (ctl_device)
  quotient  = each table's constraints (eval_packed, the permutation and
              CTL checks) recorded once as a tape and run as K6, fused
              kernels over slices of its constraint sequence, on each
              residue class of the quotient coset, the class's values one
              coset FFT of the coefficients
  openings  = power tables of zeta and g*zeta (K13) and their inner
              products with the coefficients (K5)
  FRI       = composition poly formed on the coefficients (K9), one
              batched coset LDE, the quotient over the coset (K10), fold
              (K12), re-FFT (gl_scale_powers, K1), extension-leaf trees,
              the Poseidon PoW grind (K2), query leaves evaluated at their
              points (K13's tables, K5)

On a CUDA device the quotient's constraints launch K6 (and its coset
scaling and selectors, csrc/quotient.cu), the FRI composition K9 and K10
(csrc/fri.cu), the remaining products K3, the transforms K1, the grind K2
and the evaluations K5; the Merkle hashing launches the blake3 kernels (K4
and its absorb) or the Poseidon leaf, absorb and level kernels, as
config.merkle_hasher says.

The Z polys, each quotient class, the openings' power tables, the FRI
composition and each fold and re-FFT are programs (utils/jitcache.py): on
the card, CUDA graphs captured once per process and replayed, the launches
of olavm_tpu's jitted programs. Every Fiat-Shamir challenge, and every
value derived from one, enters a program through a device bank filled
before the replay (quotient_bank, composition_bank, the fold's powers of
beta), never as a host value inside it; the commits, the Merkle trees, the
PoW grind, the query gathers and every host read stay outside.

Given an oracle with a mesh (parallel/sharded.py ShardedOracle), every rank
of the mesh runs this prove: the commits, the quotient's classes, the FRI
folds and the FRI trees are split over the ranks where they divide them,
and every rank ends with the same proof.
"""

from __future__ import annotations

import functools
import logging

import numpy as np
import torch

from ..field import extension as ge
from ..field import goldilocks as g
from ..stark.consumer import ConstraintConsumer
from ..stark.cross_table_lookup import (
    CtlCheckVars,
    eval_cross_table_lookup_checks,
)
from ..stark.stark_base import get_n_grand_product_challenge_sets
from ..utils import jitcache
from ..utils.bits import log2_strict
from ..utils.timing import TimingTree

from ..field import gf
from ..field import gfe
from ..hash import poseidon as pos
from ..hash.hashers import by_name
from ..merkle import device as dmerkle
from ..ntt import ntt as dntt
from ..parallel import sharded as psh
from .challenger import Challenger
from .config import StarkConfig
from .ctl_device import (
    DevChallenge,
    column_sig,
    ctl_data_device,
    permutation_bank,
    permutation_meta,
    permutation_z_polys_device,
)
from .fri import (
    FriInitialTreeProof,
    FriProof,
    FriQueryRound,
    FriQueryStep,
    _reduce_with_alpha,
)
from . import constraint_codegen as cg
from . import constraint_tape as ct
from . import fri_kernels as fk
from .oracle_device import (
    DevicePolynomialBatch,
    build_tree_device,
    gather_paths_dev,
)
from .ops import TorchOps
from .proof import AllProof, PublicValues, StarkOpeningSet, StarkProof
from .prover import fri_instance_for_stark
from .serialization import serialize_all_proof

logger = logging.getLogger(__name__)

# polynomials of one oracle combined by one product in the FRI composition
_COMBINE_ROWS = 16


# ---------------------------------------------------------------------------
# quotient
# ---------------------------------------------------------------------------


def _stark_key(stark) -> tuple:
    """What a program key holds of a table's STARK: its class and its
    instance state. Baked values: the trace generator's compress challenges
    (ProgramStark and BitwiseStark hold them) reach eval_packed as host
    ints, which its scalar products turn into fills or no product at all,
    so they are part of the key: a program captured for one program's
    compress challenge is never replayed for another's."""
    return (type(stark).__module__, type(stark).__qualname__,
            tuple(sorted(vars(stark).items())))


def quotient_bank(stark, config, alphas, permutation_challenges, ctl_data):
    """The quotient's scalar bank (olavm_tpu/stark/prover_device.py:112-141):
    the alphas, then each distinct permutation challenge's beta and gamma,
    then each CTL Z's; with the static metadata that reads it: per
    permutation batch ((column pairs, offset), ...), and per CTL Z its
    offset. Returns (bank values, permutation metadata, CTL offsets)."""
    values = [int(a) for a in alphas]
    perm_meta = ()
    if permutation_challenges is not None:
        pvals, offset = permutation_bank(permutation_challenges)
        base = len(values)
        perm_meta = permutation_meta(
            stark, config, permutation_challenges,
            {k: base + v for k, v in offset.items()})
        values += pvals
    ctl_offsets = []
    for zc in ctl_data.zs_columns:
        ctl_offsets.append(len(values))
        values += [zc.challenge.beta, zc.challenge.gamma]
    return values, perm_meta, tuple(ctl_offsets)


def emit_perm(consumer, F, lv, zs_local, zs_next, bank, perm_meta,
              num_permutation_zs: int) -> None:
    """The permutation argument's constraints (stark_base's
    eval_permutation_checks, permutation.rs:302-360), each challenge read
    from the bank through DevChallenge (olavm_tpu/stark/prover_device.py:190)."""
    for zi in range(num_permutation_zs):
        consumer.constraint_first_row(F.sub(zs_local[zi], F.constant(1)))
    for bi, instances in enumerate(perm_meta):
        red_lhs, red_rhs = [], []
        for column_pairs, off in instances:
            chal = DevChallenge(bank[off], bank[off + 1])
            red_lhs.append(chal.combine_ops(F, [lv[a] for a, _ in column_pairs]))
            red_rhs.append(chal.combine_ops(F, [lv[b] for _, b in column_pairs]))
        prod_lhs = red_lhs[0]
        for t in red_lhs[1:]:
            prod_lhs = F.mul(prod_lhs, t)
        prod_rhs = red_rhs[0]
        for t in red_rhs[1:]:
            prod_rhs = F.mul(prod_rhs, t)
        consumer.constraint(F.sub(F.mul(zs_next[bi], prod_rhs),
                                  F.mul(zs_local[bi], prod_lhs)))


def emit_ctls(consumer, lv, nv, zs_local, zs_next, bank, ctl_views,
              ctl_offsets, num_permutation_zs: int) -> None:
    """The CTL checks (eval_cross_table_lookup_checks) of each (columns,
    filter) view, its challenge read from the bank
    (olavm_tpu/stark/prover_device.py:210)."""
    ctl_vars = [
        CtlCheckVars(zs_local[num_permutation_zs + i],
                     zs_next[num_permutation_zs + i],
                     DevChallenge(bank[off], bank[off + 1]), columns, filt)
        for i, ((columns, filt), off) in enumerate(zip(ctl_views, ctl_offsets))
    ]
    eval_cross_table_lookup_checks(lv, nv, ctl_vars, consumer)


def emit_constraints(stark, consumer, F, lv, nv, zl, zn, bank, *,
                     perm_meta, ctl_views, ctl_offsets,
                     num_permutation_zs: int) -> None:
    """A table's quotient constraints in the host prover's order: its
    eval_packed, the permutation checks, the CTL checks."""
    stark.eval_packed(lv, nv, consumer)
    emit_perm(consumer, F, lv, zl, zn, bank, perm_meta, num_permutation_zs)
    emit_ctls(consumer, lv, nv, zl, zn, bank, ctl_views, ctl_offsets,
              num_permutation_zs)


def quotient_kernels(stark, n_cols: int, n_zs: int, *, num_alphas: int,
                     perm_meta, ctl_views, ctl_offsets,
                     num_permutation_zs: int) -> cg.Kernels:
    """The table's K6 (stark/constraint_codegen.py): emit_constraints
    recorded as a tape (stark/constraint_tape.py) over n_cols trace and
    n_zs Z columns, its slices and their source; cached by what the
    qclass program key holds of the table."""
    static = {"perm_meta": perm_meta, "ctl_views": ctl_views,
              "ctl_offsets": ctl_offsets,
              "num_permutation_zs": num_permutation_zs}
    key = ("qclass", _stark_key(stark), n_cols, n_zs, num_alphas, perm_meta,
           _ctl_sigs(ctl_views), ctl_offsets, num_permutation_zs)
    return cg.cached_kernels(key, type(stark).__name__, lambda: ct.record(
        functools.partial(emit_constraints, stark, **static), n_cols, n_zs,
        num_alphas))


def _ctl_sigs(ctl_views) -> tuple:
    return tuple((tuple(column_sig(c) for c in cols), column_sig(filt))
                 for cols, filt in ctl_views)


def quotient_class(stark, coeffs, zs_coeffs, cls, bank, pool=None, *,
                   num_alphas: int, perm_meta, ctl_views, ctl_offsets,
                   num_permutation_zs: int) -> torch.Tensor:
    """(num_alphas, n) quotient values on one residue class: the class's
    coset values of the trace and Z polynomials (the coefficients scaled by
    shift^i, gl_scale_powers, then K1), its selector columns
    (gl_quotient_selectors), and the table's constraints with the alphas
    and the Z_H inverse as the slices of its K6 (quotient_kernels), whose
    pooled constants `pool` holds (None: made here from the tape, outside a
    program only). `cls` holds the class's constants [shift, c/n, c
    g^{-1}/n, 1/c] with c = shift^n - 1, and `bank` the challenges
    (quotient_bank), so one program serves every class and every prove. On
    CPU tensors every step runs its plain version."""
    k6 = quotient_kernels(
        stark, coeffs.shape[0], zs_coeffs.shape[0], num_alphas=num_alphas,
        perm_meta=perm_meta, ctl_views=ctl_views, ctl_offsets=ctl_offsets,
        num_permutation_zs=num_permutation_zs)
    if pool is None:
        pool = gf.from_u64(k6.tape.pool, coeffs.device)
    return cg.evaluate(k6, quotient_inputs(coeffs, zs_coeffs, cls, bank, pool))


def _class_program(stark, coeffs, zs_coeffs, cls, pool, bank, **static):
    """quotient_class as the qclass program runs it, the challenge bank its
    last input."""
    return quotient_class(stark, coeffs, zs_coeffs, cls, bank, pool, **static)


def quotient_inputs(coeffs, zs_coeffs, cls, bank, pool) -> ct.Inputs:
    """A residue class's operands of K6: the trace and Z values on the
    class's coset (their next row the following one, cyclically), its
    selector columns, the bank, the pool and 1/c."""
    degree = coeffs.shape[1]
    local = dntt.ntt(cg.scale_powers(coeffs, cls[0]))
    zs_local = dntt.ntt(cg.scale_powers(zs_coeffs, cls[0]))
    sel = cg.selectors(cls, log2_strict(degree))
    return ct.Inputs(local, local, zs_local, zs_local, 1 % degree, sel, bank,
                     pool, cls[3])


def quotient_class_ops(stark, coeffs, zs_coeffs, cls, bank, *,
                       num_alphas: int, perm_meta, ctl_views, ctl_offsets,
                       num_permutation_zs: int) -> torch.Tensor:
    """quotient_class op by op through TorchOps (a K3, add or sub launch per
    field operation on the card): the yardstick that K6 is held to."""
    device = coeffs.device
    F = TorchOps(device)
    degree = coeffs.shape[1]
    degree_bits = log2_strict(degree)
    gen = g.primitive_root_of_unity(degree_bits)
    shift, c_n, c_n_last, zh_inv = cls[0], cls[1], cls[2], cls[3]
    # selectors on shift*H, where x^n - 1 == shift^n - 1 is constant:
    # L_0(x) = (x^n-1)/(n (x-1)); L_{n-1}(x) = (x^n-1) g^{-1}/(n (x-g^{-1}))
    xs = gf.mul(gf.powers(gf.scalar(gen, device), degree, device), shift)
    lagrange_first = gf.mul(c_n, gf.inv(gf.sub(xs, gf.scalar(1, device))))
    z_last = gf.sub(xs, gf.scalar(g.inv(gen), device))
    lagrange_last = gf.mul(c_n_last, gf.inv(z_last))

    local = dntt.coset_fft(coeffs, shift)
    zs_local = dntt.coset_fft(zs_coeffs, shift)
    lv, nv = list(local), list(local.roll(-1, 1))
    zl, zn = list(zs_local), list(zs_local.roll(-1, 1))

    consumer = ConstraintConsumer(F, [bank[i] for i in range(num_alphas)],
                                  z_last, lagrange_first, lagrange_last)
    emit_constraints(stark, consumer, F, lv, nv, zl, zn, bank,
                     perm_meta=perm_meta, ctl_views=ctl_views,
                     ctl_offsets=ctl_offsets,
                     num_permutation_zs=num_permutation_zs)
    return torch.stack([gf.mul(acc.expand(degree), zh_inv)
                        for acc in consumer.accumulators()])


def quotient_statics(ola_stark, config, draw=None) -> list:
    """Per table, (stark, n_zs, static metadata, bank values) as
    compute_quotient_polys_device gives quotient_class: the keyword
    arguments (num_alphas, perm_meta, ctl_views, ctl_offsets,
    num_permutation_zs) and the bank (quotient_bank) of the alphas and the
    permutation and CTL challenges, each value one call of `draw` (None:
    every value 0). The metadata depends on which challenge each column
    group reads, never on its value, so zeros stand in for a prove's
    challenges where only the metadata is wanted."""
    from .cross_table_lookup import CtlData, CtlZData
    from .stark_base import GrandProductChallenge

    draw = draw or (lambda: 0)
    nc = config.num_challenges

    def challenge_set():
        return [GrandProductChallenge(draw(), draw()) for _ in range(nc)]

    ctl_challenges = challenge_set()
    alphas = [draw() for _ in range(nc)]
    out = []
    for ti, stark in enumerate(ola_stark.starks):
        perm = None
        if stark.uses_permutation_args():
            perm = [challenge_set()
                    for _ in range(stark.permutation_batch_size())]
        num_permutation_zs = (stark.num_permutation_batches(config)
                              if perm is not None else 0)
        ctl_data = CtlData()
        for ctl in ola_stark.cross_table_lookups:
            for chal in ctl_challenges:
                for t in (*ctl.looking_tables, ctl.looked_table):
                    if t.table == ti:
                        ctl_data.zs_columns.append(CtlZData(
                            None, chal, t.columns, t.filter_column))
        values, perm_meta, ctl_offsets = quotient_bank(
            stark, config, alphas, perm, ctl_data)
        out.append((stark, num_permutation_zs + len(ctl_data.zs_columns), {
            "num_alphas": nc, "perm_meta": perm_meta,
            "ctl_views": [(zc.columns, zc.filter_column)
                          for zc in ctl_data.zs_columns],
            "ctl_offsets": ctl_offsets,
            "num_permutation_zs": num_permutation_zs}, values))
    return out


def prebuild_quotient_kernels(ola_stark, config) -> dict:
    """Build every table's K6 at once (one nvcc each, where its library is
    missing); returns seconds per built source."""
    return cg.prebuild([quotient_kernels(stark, stark.COLUMNS, n_zs, **static)
                        for stark, n_zs, static, _ in quotient_statics(
                            ola_stark, config)])


def quotient_degree_bits(stark, config) -> int:
    """log2 of the quotient coset's size over the trace's (the quotient
    degree factor rounded up to a power of two)."""
    qdf = stark.quotient_degree_factor()
    qdb = qdf.bit_length() - 1
    if (1 << qdb) < qdf:
        qdb += 1
    assert qdb <= config.fri_config.rate_bits
    return qdb


def class_constants(degree_bits: int, qdb: int, r: int, device
                    ) -> torch.Tensor:
    """quotient_class's `cls` for residue class r of the quotient coset
    g*W, |W| = n << qdb: [shift, c/n, c g^{-1}/n, 1/c] with shift = g w^r
    and c = shift^n - 1."""
    degree = 1 << degree_bits
    w = g.primitive_root_of_unity(degree_bits + qdb)
    g_last = g.inv(g.primitive_root_of_unity(degree_bits))  # gen^{n-1}
    shift = g.mul(g.MULTIPLICATIVE_GROUP_GENERATOR, pow(w, r, g.P))
    c = g.sub(pow(shift, degree, g.P), 1)
    c_n = g.mul(c, g.inv(degree))
    return gf.from_u64([shift, c_n, g.mul(c_n, g_last), g.inv(c)], device)


def compute_quotient_polys_device(stark, config, trace_batch, zs_batch,
                                  permutation_challenges, ctl_data, alphas,
                                  degree_bits, num_permutation_zs, mesh=None
                                  ) -> torch.Tensor:
    """compute_quotient_polys (prover.rs:571-705) on the device.

    The quotient coset g*W (|W| = n << qdb) splits into 2^qdb residue
    classes j = k * 2^qdb + r; class r is the coset (g * w^r) * H, its
    values one coset FFT of the coefficients on n points, and the "next
    row" of a point stays inside its class as a roll by one. Each class is
    one replay of the table's class program (quotient_class), keyed like
    olavm_tpu's "qvals"/"qfin" programs by the table's shapes and static
    metadata (olavm_tpu/stark/prover_device.py:403-416), with the class's
    constants and the challenge bank as inputs. With a mesh whose ranks
    divide the classes, each rank replays its contiguous classes and one
    all_gather, outside the programs, gives every rank all of them
    (olavm_tpu/stark/prover_device.py:353-401). Returns the
    (num_alphas * qdf, n) quotient chunks' coefficients."""
    device = trace_batch.coeffs.device
    degree = 1 << degree_bits
    qdf = stark.quotient_degree_factor()
    qdb = quotient_degree_bits(stark, config)
    size = degree << qdb

    values, perm_meta, ctl_offsets = quotient_bank(
        stark, config, alphas, permutation_challenges, ctl_data)
    bank = gf.from_u64(values, device)
    ctl_views = [(zc.columns, zc.filter_column) for zc in ctl_data.zs_columns]
    static = {"num_alphas": len(alphas), "perm_meta": perm_meta,
              "ctl_views": ctl_views, "ctl_offsets": ctl_offsets,
              "num_permutation_zs": num_permutation_zs}
    # the tape's constants enter the program as an input, as the bank does
    pool = gf.from_u64(quotient_kernels(
        stark, trace_batch.coeffs.shape[0], zs_batch.coeffs.shape[0],
        **static).tape.pool, device)
    key = ("qclass", _stark_key(stark), tuple(trace_batch.coeffs.shape),
           tuple(zs_batch.coeffs.shape), len(alphas), num_permutation_zs,
           perm_meta, _ctl_sigs(ctl_views), ctl_offsets)
    program = jitcache.cached_jit(key, functools.partial(
        _class_program, stark, **static))

    def class_values(r: int) -> torch.Tensor:
        cls = class_constants(degree_bits, qdb, r, device)
        return program(trace_batch.coeffs, zs_batch.coeffs, cls, pool, bank)

    n_classes = 1 << qdb
    if mesh is not None and n_classes % psh.coords(mesh)[1] == 0:
        classes = psh.shard_map_cat(
            mesh, "quotient", n_classes,
            lambda lo, hi: torch.stack([class_values(r)
                                        for r in range(lo, hi)]))
    else:
        classes = torch.stack([class_values(r) for r in range(n_classes)])

    # interleave classes back to natural coset order j = (k << qdb) | r
    quotient_values = classes.permute(1, 2, 0).reshape(len(alphas), size)
    coeffs = dntt.coset_ifft(quotient_values)
    limit = degree * qdf
    # the divisibility check's host read stays outside the programs
    if limit < size and bool((coeffs[:, limit:] != 0).any()):
        raise ValueError("quotient not divisible by Z_H — constraint violated")
    # split into degree-n chunks (prover.rs:463-478), alpha-major
    return coeffs[:, :limit].reshape(len(alphas) * qdf, degree)


# ---------------------------------------------------------------------------
# openings
# ---------------------------------------------------------------------------


def ext_powers(zb: torch.Tensor, n: int) -> torch.Tensor:
    """(2, n) re and im of [1, z, ..., z^{n-1}] for the extension point z
    held by the (2,) device tensor zb: one K13 launch on the card
    (gfe.powers_stacked; olavm_tpu's "extpows" program,
    olavm_tpu/stark/prover_device.py:461, doubles a table in log2(n)
    steps)."""
    return gfe.powers_stacked(gfe.GFE(zb[0], zb[1]), n)


def _ext_power_table(z, n: int, device) -> gfe.GFE:
    """Device [1, z, ..., z^{n-1}] for a host extension point z (a
    challenge: it enters the program as an input)."""
    prog = jitcache.cached_jit(("extpows", n),
                               functools.partial(ext_powers, n=n))
    out = prog(gf.from_u64(np.asarray(ge.t(z), dtype=np.uint64), device))
    return gfe.GFE(out[0], out[1])


def _openings_device(trace_batch, zs_batch, quotient_batch,
                     z_values: torch.Tensor, zeta, gen: int,
                     num_permutation_zs: int) -> StarkOpeningSet:
    """StarkOpeningSet::new (proof.rs:199-233): every polynomial at zeta and
    g*zeta (one K5 launch per batch for both points), plus the last CTL Z
    values (base values at g^{n-1})."""
    device = trace_batch.coeffs.device
    degree = trace_batch.coeffs.shape[1]
    pows = _ext_power_table(zeta, degree, device)
    pows_n = _ext_power_table(ge.scalar_mul(zeta, gen), degree, device)
    both = torch.stack([pows.re, pows.im, pows_n.re, pows_n.im])
    trace_z, trace_gz = trace_batch.eval_at_ext_rows(both)
    zs_z, zs_gz = zs_batch.eval_at_ext_rows(both)
    nq = quotient_batch.coeffs.shape[1]
    qpows = pows if nq == degree else _ext_power_table(zeta, nq, device)
    return StarkOpeningSet(
        trace_z, trace_gz, zs_z, zs_gz,
        gf.to_u64(z_values[num_permutation_zs:, -1]),
        quotient_batch.eval_at_ext(qpows),
    )


# ---------------------------------------------------------------------------
# FRI
# ---------------------------------------------------------------------------


def fri_pow_device(current_hash: list[int], fri_config, device) -> int:
    """PoW grind (fri/prover.rs:126-148): batches of consecutive nonces
    through one Poseidon launch each; the LOWEST valid nonce is the witness
    (stark/fri.py fri_proof_of_work), whatever the batch size."""
    device = torch.device(device)
    pow_bits = fri_config.proof_of_work_bits
    assert pow_bits <= 32
    B = 1 << 18 if device.type == "cuda" else 1 << 10
    hi_bound = 1 << (32 - pow_bits)
    h = gf.from_u64(np.asarray(current_hash, dtype=np.uint64), device)
    start = 0
    while start + B <= 1 << 32:
        state = torch.zeros((pos.WIDTH, B), dtype=torch.int64, device=device)
        state[0:4] = h[:, None]
        state[4] = torch.arange(start, start + B, dtype=torch.int64,
                                device=device)
        out0 = pos.permute(state)[0]
        hits = torch.nonzero(((out0 >> 32) & gf.M32) < hi_bound)
        if hits.numel():
            return start + int(hits[0, 0])
        start += B
    raise RuntimeError("PoW grind exhausted u32 nonces")


class _DeviceExtTree:
    """FRI commit-phase tree over extension values: the values in
    bit-reversed order, `arity` consecutive values per leaf. With a mesh
    whose ranks divide the leaves in pairs, each rank hashes its contiguous
    leaves and reduces its subtree (olavm_tpu/stark/prover_device.py:574-643);
    every rank holds the whole tree."""

    def __init__(self, values: gfe.GFE, arity: int, cap_height: int,
                 hasher_kind: str = "blake3", mesh=None):
        n = values.shape[0]
        perm = dntt.bitrev_perm(n, values.re.device)
        self.values = gfe.GFE(values.re[perm], values.im[perm])
        self.arity = arity
        self.n_leaves = n // arity
        self.cap_height = cap_height
        # leaf words: re_0, im_0, re_1, im_1, ... as u64 columns
        cols = torch.stack([self.values.re.reshape(self.n_leaves, arity),
                            self.values.im.reshape(self.n_leaves, arity)],
                           dim=-1).reshape(self.n_leaves, 2 * arity)
        if mesh is not None and self.n_leaves % (2 * psh.coords(mesh)[1]) == 0:
            rank, size = psh.coords(mesh)
            share = self.n_leaves // size
            digs = dmerkle.leaf_digests(
                cols[rank * share:(rank + 1) * share].T.contiguous(),
                hasher_kind)
            psh.PHASES["tree"] += 1
            self.levels, self.cap = psh.sharded_tree(mesh, digs, cap_height,
                                                     hasher_kind)
        else:
            digs = dmerkle.leaf_digests(cols.T.contiguous(), hasher_kind)
            self.levels, self.cap = build_tree_device(digs, cap_height,
                                                      hasher_kind)

    def leaf_values(self, coset_indices: np.ndarray) -> np.ndarray:
        """(k,) leaf indices -> host (k, arity, 2) u64 extension values."""
        idx = torch.as_tensor(np.asarray(coset_indices, dtype=np.int64),
                              device=self.values.re.device)
        flat = (idx[:, None] * self.arity
                + torch.arange(self.arity, device=idx.device)).reshape(-1)
        out = gfe.to_u64_pair(self.values[flat])
        return out.reshape(len(coset_indices), self.arity, 2)

    def paths(self, coset_indices: np.ndarray):
        num_path_levels = log2_strict(self.n_leaves) - self.cap_height
        return dmerkle.paths_to_host(
            gather_paths_dev(self.levels, coset_indices, num_path_levels))


def prove_openings_device(instance, openings_batches, oracles, challenger,
                          config, degree_bits, mesh=None) -> FriProof:
    """PolynomialBatch::prove_openings + fri_proof (fri/oracle.rs:167-243,
    fri/prover.rs:20-150), values first: over the LDE coset,
    F(x) = x * sum_b alpha^{suffix_b} (C_b(x) - y_b) / (x - z_b), with
    C_b = sum_i alpha^i p_i and y_b = C_b(z_b) the alpha-reduction of the
    opened values. C_b is formed on the coefficients (every oracle's
    polynomials have n of them) and takes one coset LDE of its re and im
    parts: by linearity the values the sum over LDE rows would give, at 1/8
    of the arithmetic and with no LDE kept. One coset iNTT gives the
    coefficients to fold. The whole composition (K9, K1, K10, K1 inverse
    and the coset scaling: fri_composition) is one program (olavm_tpu's
    "horner_lde", "fri_xs", "friquot", "frimulx" and "fri_ifft" programs,
    olavm_tpu/stark/prover_device.py:733-853), keyed by the batches'
    structure; alpha's powers, the points and the opened values, all
    derived from challenges, are its bank (composition_bank)."""
    device = oracles[0].coeffs.device
    rate_bits = config.fri_config.rate_bits
    alpha = ge.t(challenger.get_extension_challenge())
    reduced = [_reduce_with_alpha(batch, alpha) for batch in openings_batches]
    plan, values = composition_bank(instance, alpha, reduced)
    key = ("fricomp", degree_bits, rate_bits, plan,
           tuple(tuple(o.coeffs.shape) for o in oracles))
    prog = jitcache.cached_jit(key, functools.partial(
        fri_composition, plan=plan, rate_bits=rate_bits))
    v_re, v_im, c_re, c_im = prog(
        *[o.coeffs for o in oracles],
        gf.from_u64(np.asarray(values, dtype=np.uint64), device))
    return fri_proof_device(oracles, gfe.GFE(c_re, c_im),
                            gfe.GFE(v_re, v_im), challenger, config.fri_config,
                            degree_bits, config.merkle_hasher, mesh)


def composition_bank(instance, alpha, reduced) -> tuple[tuple, list[int]]:
    """The FRI composition's static plan and its bank. Per batch: its runs
    of consecutive polynomials of one oracle, at most 16 each, as (oracle,
    first index, count, bank offset of the run's alpha powers: count re
    parts, then count im parts; a run with the rows and powers of an
    earlier batch's run has that run's offset), and the bank offset of the
    batch's point, its reduced opening y and alpha^{len(batch)}, re and im
    each."""
    plan, values = [], []
    placed: dict = {}  # (oracle, first index, powers) -> its bank offset
    for batch, y in zip(instance.batches, reduced):
        runs = []  # [oracle, first index, host alpha powers]
        pw = (1, 0)
        for oi, pi in batch.polynomials:
            if (runs and runs[-1][0] == oi
                    and runs[-1][1] + len(runs[-1][2]) == pi
                    and len(runs[-1][2]) < _COMBINE_ROWS):
                runs[-1][2].append(pw)
            else:
                runs.append([oi, pi, [pw]])
            pw = ge.t_mul(pw, alpha)
        batch_runs = []
        for oi, p0, pws in runs:
            # a run of an earlier batch with the same rows and powers (the
            # trace and Z rows of batches 0 and 1) shares its bank words, so
            # the plan nests and K9 sums those rows once for both
            run = (oi, p0, tuple(pws))
            if run not in placed:
                placed[run] = len(values)
                values += [p[0] for p in pws] + [p[1] for p in pws]
            batch_runs.append((oi, p0, len(pws), placed[run]))
        plan.append((tuple(batch_runs), len(values)))
        for v in (ge.t(batch.point), ge.t(y), pw):
            values += [int(v[0]), int(v[1])]
    return tuple(plan), values


def fri_composition(*inputs, plan, rate_bits: int):
    """The composition's values and coefficients over the LDE coset, as
    (values re, values im, coefficients re, coefficients im); `inputs` are
    the oracles' (C, n) coefficients and the bank (composition_bank). K9
    writes every batch's alpha-combination, times the coset's shift^j, as
    the input of one batched K1 forward (the batches' coset LDEs), K10 forms
    F * x over the coset from them, and K1 inverse with gl_scale_powers
    (shift^-j / size) gives the coefficients (stark/fri_kernels.py): no K3,
    add, sub or K7 launch."""
    *oracle_coeffs, bank = inputs
    lde = dntt.ntt(fk.fri_combine(oracle_coeffs, bank, plan, rate_bits))
    values = fk.fri_quotient(lde, bank, plan)
    del lde
    c = dntt.coset_ifft(values, fk.SHIFT)
    return values[0], values[1], c[0], c[1]


def fri_composition_ops(*inputs, plan, rate_bits: int):
    """fri_composition op by op (the chain that K9 and K10 replaced): each
    run's rows times their alpha powers and summed by halving, the runs
    summed, one coset LDE a batch, the quotient by sub, gfe.inv and gfe.mul
    against a table of the coset's points, the degree bump, the coset iNTT.
    The yardstick that the kernels and their plain versions are held to."""
    *oracle_coeffs, bank = inputs
    device = bank.device
    size = oracle_coeffs[0].shape[1] << rate_bits
    size_bits = log2_strict(size)
    shift = g.MULTIPLICATIVE_GROUP_GENERATOR
    xs = gf.mul(gf.powers(gf.scalar(g.primitive_root_of_unity(size_bits),
                                    device), size, device),
                gf.scalar(shift, device))

    def ext(off):
        return gfe.GFE(bank[off], bank[off + 1])

    final = gfe.zeros((size,), device)
    for runs, off in plan:
        # C_b = sum_i alpha^i p_i: a run is one product with the column of
        # its alpha powers and a pairwise sum (modular addition is exact,
        # so the order of the terms does not change the result)
        comp = None
        for oi, p0, k, roff in runs:
            rows = oracle_coeffs[oi][p0:p0 + k]
            term = gfe.GFE(
                _sum_rows(gf.mul(rows, bank[roff:roff + k][:, None])),
                _sum_rows(gf.mul(rows, bank[roff + k:roff + 2 * k][:, None])))
            comp = term if comp is None else gfe.add(comp, term)
        v = dntt.coset_lde(torch.stack([comp.re, comp.im]), rate_bits,
                           gf.scalar(shift, device))
        num = gfe.sub(gfe.GFE(v[0], v[1]), ext(off + 2))
        den = gfe.sub(gfe.from_base(xs), ext(off))
        q = gfe.mul(num, gfe.inv(den))
        # alpha^{len(batch)} shifts the earlier batches past this one
        final = gfe.add(gfe.mul(final, ext(off + 4)), q)

    # degree bump F <- X * F (plonky2 PR #436)
    values = gfe.mul_base(final, xs)
    c = dntt.scale_by_powers(dntt.intt(torch.stack([values.re, values.im])),
                             gf.scalar(g.inv(shift), device))
    return values.re, values.im, c[0], c[1]


def _sum_rows(x: torch.Tensor) -> torch.Tensor:
    """Modular sum of the rows of (m, n) -> (n,), halving the rows (each
    half a contiguous slice)."""
    while x.shape[0] > 1:
        h = x.shape[0] // 2
        s = gf.add(x[:h], x[h:2 * h])
        x = torch.cat([s, x[2 * h:]]) if x.shape[0] % 2 else s
    return x[0]


def fri_fold(coeffs: gfe.GFE, beta, arity: int, mesh=None) -> gfe.GFE:
    """One FRI fold (olavm_tpu/stark/prover_device.py:887-921): coeffs[k * arity + i] ->
    sum_i coeffs[k * arity + i] * beta^i for a host extension beta, a
    challenge: beta's powers, computed on the host, are the fold program's
    bank (olavm_tpu's "frifold" program, :943, one per (m, arity)). With a
    mesh whose ranks divide the folded rows, each rank folds its contiguous
    rows and one all_gather, outside the program, gives every rank all of
    them (olavm_tpu/stark/prover_device.py:923-943)."""
    folded = fri_fold_rows(coeffs, beta, arity, mesh)
    return gfe.GFE(folded[0], folded[1])


def fri_fold_rows(coeffs: gfe.GFE, beta, arity: int, mesh=None
                  ) -> torch.Tensor:
    """fri_fold as one (2, m / arity) tensor of re and im rows."""
    beta = ge.t(beta)
    pws = [(1, 0)]
    for _ in range(1, arity):
        pws.append(ge.t_mul(pws[-1], beta))
    bpows = gf.from_u64(np.asarray(pws, dtype=np.uint64).T.copy(),
                        coeffs.re.device)
    rows = coeffs.shape[0] // arity

    def fold(re, im):
        prog = jitcache.cached_jit(("frifold", re.shape[0], arity), fold_stacked)
        return prog(re, im, bpows)

    if mesh is not None and rows % psh.coords(mesh)[1] == 0:
        return psh.shard_map_cat(
            mesh, "fold", rows, lambda lo, hi: fold(
                coeffs.re[lo * arity:hi * arity],
                coeffs.im[lo * arity:hi * arity]), dim=1)
    return fold(coeffs.re, coeffs.im)


def fold_stacked(re: torch.Tensor, im: torch.Tensor, bpows: torch.Tensor
                 ) -> torch.Tensor:
    """fri_fold of (m,) re and im parts by the (2, arity) re and im parts of
    beta's powers, as one (2, m / arity) tensor of re and im: K12 (one
    launch, stark/fri_kernels.fri_fold) on the card."""
    return fk.fri_fold(re, im, bpows)


def fri_refft(rows: torch.Tensor, shift: int) -> gfe.GFE:
    """The folded polynomial's values on the next coset, shift * H: one
    coset FFT of the (2, m) re and im rows of its coefficients (the shift
    by value to gl_scale_powers, then K1), olavm_tpu's "fri_refft" program
    (olavm_tpu/stark/prover_device.py:954), keyed by the size and the
    shift, a constant of the round."""
    prog = jitcache.cached_jit(("fri_refft", rows.shape[1], shift),
                               functools.partial(dntt.coset_fft, shift=shift))
    v = prog(rows)
    return gfe.GFE(v[0], v[1])


def fri_proof_device(initial_oracles, coeffs: gfe.GFE, values: gfe.GFE,
                     challenger, config, degree_bits: int,
                     hasher_kind: str, mesh=None) -> FriProof:
    """FRI commit phase (trees, folds, re-FFTs), final polynomial, PoW and
    query gathers; the trees are hashed with the named Merkle hasher. With
    a mesh the trees and folds are sharded where its ranks divide them."""
    hasher = by_name(hasher_kind)
    device = coeffs.re.device
    arity_schedule = config.reduction_arity_bits(degree_bits)

    trees: list[_DeviceExtTree] = []
    shift = g.MULTIPLICATIVE_GROUP_GENERATOR
    for arity_bits in arity_schedule:
        arity = 1 << arity_bits
        tree = _DeviceExtTree(values, arity, config.cap_height, hasher_kind,
                              mesh)
        challenger.observe_cap(tree.cap, hasher)
        trees.append(tree)

        beta = ge.t(challenger.get_extension_challenge())
        folded = fri_fold_rows(coeffs, beta, arity, mesh)
        coeffs = gfe.GFE(folded[0], folded[1])
        shift = pow(shift, arity, g.P)
        values = fri_refft(folded, shift)

    final_len = coeffs.shape[0] >> config.rate_bits
    final_coeffs = gfe.to_u64_pair(coeffs[:final_len])
    for c in final_coeffs:
        challenger.observe_extension_element(c)

    pow_witness = fri_pow_device(challenger.get_hash(), config, device)

    lde_n = 1 << (degree_bits + config.rate_bits)
    query_indices = [
        c % lde_n for c in challenger.get_n_challenges(config.num_query_rounds)
    ]
    k = len(query_indices)
    # every initial oracle has n coefficients and the same LDE: one power
    # table of the query points serves them all
    pows = initial_oracles[0].query_powers(query_indices)
    leaves = [o.query_leaves(query_indices, pows) for o in initial_oracles]
    del pows
    paths = [o.prove_batch(query_indices) for o in initial_oracles]
    steps_eval, steps_path = [], []
    xi = np.asarray(query_indices, dtype=np.int64)
    for tree, arity_bits in zip(trees, arity_schedule):
        coset = xi >> arity_bits
        steps_eval.append(tree.leaf_values(coset))
        steps_path.append(tree.paths(coset))
        xi = coset

    query_rounds = []
    for qi in range(k):
        initial = FriInitialTreeProof([
            ([int(v) for v in leaves[o][qi]], paths[o][qi])
            for o in range(len(initial_oracles))
        ])
        steps = [FriQueryStep(steps_eval[i][qi], steps_path[i][qi])
                 for i in range(len(arity_schedule))]
        query_rounds.append(FriQueryRound(initial, steps))

    return FriProof(
        commit_phase_merkle_caps=[t.cap for t in trees],
        query_round_proofs=query_rounds,
        final_poly=final_coeffs,
        pow_witness=pow_witness,
    )


# ---------------------------------------------------------------------------
# orchestration (the host prover's transcript, stark/prover.py)
# ---------------------------------------------------------------------------


def prove_single_table_device(stark, config, trace_values: torch.Tensor,
                              trace_batch: DevicePolynomialBatch, ctl_data,
                              challenger, timing,
                              oracle=DevicePolynomialBatch) -> StarkProof:
    degree = trace_values.shape[1]
    degree_bits = log2_strict(degree)
    rate_bits = config.fri_config.rate_bits
    cap_height = config.fri_config.cap_height
    hasher = config.hasher()
    total_arities = sum(config.fri_config.reduction_arity_bits(degree_bits))
    assert total_arities <= degree_bits + rate_bits - cap_height
    # a mesh-backed oracle (parallel.sharded.ShardedOracle) also shards the
    # quotient classes, FRI folds and FRI trees over its mesh
    mesh = getattr(oracle, "mesh", None)

    challenger.compact()

    permutation_challenges = None
    permutation_zs: list[torch.Tensor] = []
    if stark.uses_permutation_args():
        permutation_challenges = get_n_grand_product_challenge_sets(
            challenger, config.num_challenges, stark.permutation_batch_size())
        with timing.scope("permutation Z polys"):
            permutation_zs = permutation_z_polys_device(
                stark, config, trace_values, permutation_challenges)
    num_permutation_zs = len(permutation_zs)

    z_list = list(permutation_zs) + [zc.z for zc in ctl_data.zs_columns]
    assert z_list, "No CTL?"
    z_values = torch.stack(z_list)

    with timing.scope("Z commitment"):
        zs_batch = oracle.from_values(
            z_values, rate_bits, cap_height, config.merkle_hasher)
    challenger.observe_cap(zs_batch.cap, hasher)

    alphas = challenger.get_n_challenges(config.num_challenges)

    with timing.scope("compute quotient polys"):
        quotient_coeffs = compute_quotient_polys_device(
            stark, config, trace_batch, zs_batch, permutation_challenges,
            ctl_data, alphas, degree_bits, num_permutation_zs, mesh)

    with timing.scope("quotient commitment"):
        quotient_batch = oracle.from_coeffs(
            quotient_coeffs, rate_bits, cap_height, config.merkle_hasher)
    challenger.observe_cap(quotient_batch.cap, hasher)

    zeta = challenger.get_extension_challenge()
    if ge.is_one(ge.exp_pow2(zeta, degree_bits)):
        raise ValueError("opening point is in the subgroup")
    gen = g.primitive_root_of_unity(degree_bits)

    with timing.scope("openings"):
        openings = _openings_device(trace_batch, zs_batch, quotient_batch,
                                    z_values, zeta, gen, num_permutation_zs)

    openings_batches = openings.to_fri_openings()
    for batch in openings_batches:
        challenger.observe_extension_elements(batch)

    instance = fri_instance_for_stark(
        stark, zeta, gen, degree_bits, len(ctl_data), config)

    with timing.scope("FRI opening proof"):
        opening_proof = prove_openings_device(
            instance, openings_batches, [trace_batch, zs_batch, quotient_batch],
            challenger, config, degree_bits, mesh)

    caps = (trace_batch.cap, zs_batch.cap, quotient_batch.cap)
    for b in (trace_batch, zs_batch, quotient_batch):
        b.free()
    return StarkProof(
        trace_cap=caps[0],
        permutation_ctl_zs_cap=caps[1],
        quotient_polys_cap=caps[2],
        openings=openings,
        opening_proof=opening_proof,
    )


def prove_with_traces_device(ola_stark, config: StarkConfig,
                             trace_poly_values: list[np.ndarray],
                             public_values: PublicValues | None = None,
                             timing: TimingTree | None = None, *,
                             device="cuda",
                             oracle=DevicePolynomialBatch,
                             programs: bool = True) -> AllProof:
    """Device analogue of prover.prove_with_traces: the same challenger
    transcript, every heavy phase on `device`. trace_poly_values: per table
    (num_cols, degree) uint64 host arrays. The prove runs on the card unless
    the caller asks for another device (the CPU tests pass "cpu"); without a
    card the default raises, it never carries on on the CPU by itself. A
    Merkle hasher without a device path (keccak) raises at once: the host
    prover, stark/prover.py, runs it. `oracle` makes the commitments; the
    sharded prover (parallel/sharded.py) passes a ShardedOracle, whose mesh
    also shards the quotient and FRI, and every rank's table proofs are
    then checked to agree. On the card the grand products, the quotient's
    classes, the openings' power tables and the FRI composition, folds and
    re-FFTs run as programs (utils/jitcache.py: CUDA graphs captured at
    their first use in the process and replayed after; a prove that
    outgrows the programs' buffers frees those that earlier proves' graphs
    held, jitcache.begin_prove); `programs=False` issues them op by op
    instead (the counterpart of olavm_tpu's OLAVM_NO_EXPORT_CACHE), with
    the same proof."""
    jitcache.begin_prove()
    with jitcache.enabled(programs):
        return _prove_with_traces_device(ola_stark, config, trace_poly_values,
                                         public_values, timing, device, oracle)


def _prove_with_traces_device(ola_stark, config, trace_poly_values,
                              public_values, timing, device, oracle
                              ) -> AllProof:
    timing = timing or TimingTree()
    device = torch.device(device)
    dmerkle.check_hasher(config.merkle_hasher)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "prove_with_traces_device: no CUDA device is available; pass "
            "device=\"cpu\" to prove on the host")
    rate_bits = config.fri_config.rate_bits
    cap_height = config.fri_config.cap_height
    hasher = config.hasher()
    mesh = getattr(oracle, "mesh", None)
    if device.type == "cuda":
        with timing.scope("build quotient kernels"):
            prebuild_quotient_kernels(ola_stark, config)

    with timing.scope("upload traces"):
        values_dev = [gf.from_u64(t, device) for t in trace_poly_values]

    with timing.scope("compute trace commitments"):
        trace_batches = []
        for ti, v in enumerate(values_dev):
            logger.info("trace commit %d/%d shape=%s", ti + 1, len(values_dev),
                        tuple(v.shape))
            trace_batches.append(oracle.from_values(
                v, rate_bits, cap_height, config.merkle_hasher))

    challenger = Challenger()
    for b in trace_batches:
        challenger.observe_cap(b.cap, hasher)

    with timing.scope("cross_table_lookup_data"):
        ctl_data_per_table = ctl_data_device(
            config, values_dev, ola_stark.cross_table_lookups, challenger)

    stark_proofs = []
    for idx, stark in enumerate(ola_stark.starks):
        logger.info("prove table %d/%d (%s)", idx + 1, len(ola_stark.starks),
                    type(stark).__name__)
        with timing.scope(f"prove table {idx}"):
            stark_proofs.append(prove_single_table_device(
                stark, config, values_dev[idx], trace_batches[idx],
                ctl_data_per_table[idx], challenger, timing, oracle))
        if mesh is not None:
            psh.check_agree(mesh, serialize_all_proof(AllProof(
                stark_proofs[-1:], [], PublicValues())), f"table {idx}")
        # release what only this table needed
        values_dev[idx] = None
        ctl_data_per_table[idx] = None

    return AllProof(
        stark_proofs=stark_proofs,
        compress_challenges=ola_stark.compress_challenges(),
        public_values=public_values or PublicValues(),
    )
