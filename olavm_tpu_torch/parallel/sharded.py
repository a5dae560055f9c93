"""The sharded prover on torch.distributed, one process per GPU; counterpart
of olavm_tpu/parallel/sharded.py.

The TPU package is single-controller: one process drives every chip of a
mesh through shard_map. Here every rank runs the same deterministic prover
(SPMD) on its own card: the heavy phases are split over the ranks,
collectives give every rank their results, and every rank ends with the
same proof bytes. A single process driving several cards would still make
every kernel launch from one host thread, and launches are what the prove
waits on; each rank here launches only its own share.

What is split, each with the TPU package's own layout condition, and
gathered over the whole mesh (the collectives run over every rank, as
`axes = tuple(mesh.axis_names)` does there):

- the commit (ShardedOracle, sharded_batch_from_values): each rank iNTTs its
  share of the columns and one all_gather gives every rank the (C, n)
  coefficients, which the quotient, the openings and FRI read on every
  rank. Rank r then owns the bit-reversed leaves [r L/W, (r+1) L/W) of
  the L = n << rate_bits LDE points: they are the points j with
  j = rev(r) (mod W), one coset FFT of size L/W on the shift
  g * w_L^rev(r), in bit-reversed order. So a rank computes its leaves from
  the coefficients directly, with no transpose (the TPU package moves its
  whole LDE through one all_to_all), streams them through the leaf hash in
  16-column blocks as the single-device commit does, and reduces its
  subtree; one all_gather of the levels and a few tail levels on every
  rank finish the tree;
- the quotient's residue classes (when the ranks divide them), the FRI fold
  (when they divide the folded rows) and the FRI trees (when they divide
  the leaves in pairs): stark/prover_device.py, through shard_map_cat and
  sharded_tree.

The challenger, the grand products, the openings, the PoW grind and the
query gathers run on every rank. Every field value is exact, so each
sharded phase gives the single-device phase's bits, and the proof is byte
for byte the single-device proof. PHASES counts the sharded phases run.

Launching: run_ranks spawns one process per rank with a file:// rendezvous
(no network port); under torchrun the functions here work on the process
group it initialised. "nccl" is the backend on cards, one rank per card;
two ranks sharing one card must use "gloo", which stages CUDA tensors
through host memory.
"""

from __future__ import annotations

import datetime
import hashlib
import os
import pickle
import tempfile

import torch
import torch.distributed as dist

from ..field import gf
from ..field import goldilocks as g
from ..merkle import device as dmerkle
from ..ntt import ntt as dntt
from ..stark.oracle_device import DevicePolynomialBatch
from ..utils.bits import log2_strict, reverse_bits

# sharded phase -> times this process ran it since reset_phases()
PHASES = {"intt": 0, "commit": 0, "quotient": 0, "fold": 0, "tree": 0}
# a rank that waits longer than this at a collective fails
COLLECTIVE_TIMEOUT = datetime.timedelta(seconds=600)


def reset_phases() -> None:
    for k in PHASES:
        PHASES[k] = 0


def default_backend(device_type: str) -> str:
    """The process group's backend when none is named: NCCL between cards,
    gloo on the CPU."""
    return "nccl" if device_type == "cuda" else "gloo"


def mesh_shape(n_devices: int) -> tuple[int, int]:
    """(col, row) as square as possible, the row axis the longer (the TPU
    package's rule)."""
    c = 1 << ((n_devices.bit_length() - 1) // 2)
    while n_devices % c:
        c >>= 1
    return c, n_devices // c


def local_rank() -> int:
    """The rank among this host's processes (LOCAL_RANK, as torchrun and
    run_ranks set it)."""
    return int(os.environ.get("LOCAL_RANK", dist.get_rank()))


def make_mesh(n_devices: int | None = None, shape=None,
              axis_names=("col", "row"), device_type: str = "cuda"):
    """A DeviceMesh over the initialised process group, (col, row) as
    square as possible unless `shape` is given; it must span the whole
    group. On "cuda" this rank's card becomes cuda:(local rank % cards).
    Raises when no process group exists or when "cuda" has no card: it
    never proves on the CPU by itself."""
    from torch.distributed.device_mesh import init_device_mesh

    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError(
            "make_mesh: no torch.distributed process group is initialised; "
            "start the ranks with torchrun or parallel.sharded.run_ranks")
    world = dist.get_world_size()
    n_devices = world if n_devices is None else n_devices
    if n_devices != world:
        raise ValueError(f"make_mesh: the mesh must span the process group "
                         f"({world} ranks), not {n_devices}")
    shape = tuple(mesh_shape(n_devices) if shape is None else shape)
    if device_type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "make_mesh: no CUDA device is available; pass "
                "device_type=\"cpu\" (with the gloo backend) to shard on the "
                "host")
        torch.cuda.set_device(local_rank() % torch.cuda.device_count())
    elif device_type != "cpu":
        raise ValueError(f"make_mesh: device_type {device_type!r} is neither "
                         f"\"cuda\" nor \"cpu\"")
    return init_device_mesh(device_type, shape,
                            mesh_dim_names=tuple(axis_names))


def coords(mesh) -> tuple[int, int]:
    """(this rank's index in the flattened mesh, the mesh's size). The mesh
    must hold the group's ranks in order, as make_mesh builds it, so that
    the flattened index is the rank and the group's collectives run over
    the whole mesh in mesh order."""
    ranks = mesh.mesh.flatten().tolist()
    if ranks != list(range(dist.get_world_size())):
        raise ValueError(f"the mesh must hold ranks 0..{dist.get_world_size() - 1} "
                         f"in order, not {ranks}")
    return dist.get_rank(), len(ranks)


def all_gather(mesh, t: torch.Tensor) -> list[torch.Tensor]:
    """Every rank's `t` (the same shape on every rank), in rank order."""
    coords(mesh)
    t = t.contiguous()
    out = [torch.empty_like(t) for _ in range(dist.get_world_size())]
    dist.all_gather(out, t)
    return out


def shard_map_cat(mesh, phase: str, total: int, fn, dim: int = 0
                  ) -> torch.Tensor:
    """fn(lo, hi) over this rank's contiguous share [lo, hi) of `total`
    items (the ranks must divide them), every rank's result concatenated
    along `dim` in rank order. Counts one run of `phase`."""
    rank, size = coords(mesh)
    if total % size:
        raise ValueError(f"{phase}: {size} ranks do not divide {total} items")
    share = total // size
    PHASES[phase] += 1
    return torch.cat(all_gather(mesh, fn(rank * share, (rank + 1) * share)),
                     dim=dim)


def check_agree(mesh, data: bytes, what: str) -> None:
    """Raise unless every rank holds the same bytes (a diverged transcript
    would otherwise show only when the proof fails to verify)."""
    digest = torch.frombuffer(bytearray(hashlib.sha256(data).digest()),
                              dtype=torch.int64)
    if mesh.device_type == "cuda":
        digest = digest.cuda()
    digests = [d.tolist() for d in all_gather(mesh, digest)]
    if any(d != digests[0] for d in digests):
        raise RuntimeError(f"{what}: the ranks' results differ "
                           f"(sha256 words {digests})")


# ---------------------------------------------------------------------------
# the sharded commit
# ---------------------------------------------------------------------------


def sharded_intt(mesh, values: torch.Tensor) -> torch.Tensor:
    """(C, n) values on every rank -> their coefficients on every rank: each
    rank iNTTs its share of the columns (zero columns pad C to a multiple of
    the mesh), one all_gather."""
    C, n = values.shape
    _, size = coords(mesh)
    share = -(-C // size)
    padded = torch.cat([values, values.new_zeros(share * size - C, n)])
    return shard_map_cat(mesh, "intt", share * size,
                         lambda lo, hi: dntt.intt(padded[lo:hi]))[:C]


def owned_leaf_values(coeffs: torch.Tensor, rate_bits: int, rank: int,
                      size: int) -> torch.Tensor:
    """The LDE values behind rank `rank`'s share of the bit-reversed leaves,
    in natural order of their coset: (C, L/size), L = n << rate_bits.

    Leaf position p = rank * L/size + k is the LDE point j = rev(p), and
    j = rev_{L/size}(k) * size + rev_size(rank): the coset of size L/size on
    the shift g * w_L^rev_size(rank), its value m = rev(k) at leaf k. Where
    L/size < n the shift-scaled coefficients are first folded mod L/size
    (x^(L/size) = 1 on that coset)."""
    n = coeffs.shape[1]
    lde_bits = log2_strict(n) + rate_bits
    rank_bits = log2_strict(size)
    shift = g.mul(g.MULTIPLICATIVE_GROUP_GENERATOR,
                  pow(g.primitive_root_of_unity(lde_bits),
                      reverse_bits(rank, rank_bits), g.P))
    m = 1 << (lde_bits - rank_bits)
    if m >= n:
        return dntt.coset_lde(coeffs, rate_bits - rank_bits, shift)
    parts = list(dntt.scale_by_powers(coeffs, shift).split(m, dim=1))
    while len(parts) > 1:
        parts = [gf.add(parts[i], parts[i + 1])
                 for i in range(0, len(parts), 2)]
    return dntt.ntt(parts[0])


def sharded_tree(mesh, local_digs: torch.Tensor, cap_height: int,
                 hasher_kind: str):
    """(8, N/W) digests of this rank's contiguous leaves -> the whole tree
    on every rank, (levels below the cap, host cap), as build_tree_device
    gives it: each rank reduces its subtree while the level is above the
    cap and it holds a pair, one all_gather of those levels, the tail levels
    on every rank."""
    _, size = coords(mesh)
    cap = 1 << cap_height
    local = [local_digs]
    while local[-1].shape[1] * size > cap and local[-1].shape[1] >= 2:
        local.append(dmerkle.compress_level(local[-1], hasher_kind))
    widths = [lv.shape[1] for lv in local]
    parts = all_gather(mesh, torch.cat(local, dim=1))
    levels, start = [], 0
    for w in widths:
        levels.append(torch.cat([p[:, start:start + w] for p in parts], dim=1))
        start += w
    while levels[-1].shape[1] > cap:
        levels.append(dmerkle.compress_level(levels[-1], hasher_kind))
    return levels, dmerkle.digests_to_u64(levels.pop())


def sharded_batch_from_coeffs(mesh, coeffs: torch.Tensor, rate_bits: int,
                              cap_height: int, hasher_kind: str = "blake3"
                              ) -> DevicePolynomialBatch:
    """DevicePolynomialBatch.from_coeffs with the leaves and the subtrees
    split over the ranks; the coefficients (on every rank) are kept as
    given. Its levels and cap equal the single-device commit's."""
    dmerkle.check_hasher(hasher_kind)
    rank, size = coords(mesh)
    C, n = coeffs.shape
    share = (n << rate_bits) // size
    if share == 0:
        raise ValueError(f"{size} ranks exceed the {n << rate_bits} leaves")
    PHASES["commit"] += 1
    if C <= dmerkle.NOOP_MAX:
        digs = dmerkle.leaf_digests(
            owned_leaf_values(coeffs, rate_bits, rank, size), hasher_kind)
    else:
        stream = dmerkle.LeafStream(C, share, hasher_kind)
        block = dmerkle.STREAM_BLOCK_COLS
        for s in range(0, C, block):
            stream.absorb(owned_leaf_values(coeffs[s:s + block], rate_bits,
                                            rank, size))
        digs = stream.finalize()
    digs = digs[:, dntt.bitrev_perm(share, coeffs.device)]
    levels, cap = sharded_tree(mesh, digs, cap_height, hasher_kind)
    return DevicePolynomialBatch(coeffs, levels, cap, rate_bits)


def sharded_batch_from_values(mesh, values: torch.Tensor, rate_bits: int,
                              cap_height: int, hasher_kind: str = "blake3"
                              ) -> DevicePolynomialBatch:
    """DevicePolynomialBatch.from_values on the mesh: the column-sharded
    iNTT, then sharded_batch_from_coeffs."""
    return sharded_batch_from_coeffs(mesh, sharded_intt(mesh, values),
                                     rate_bits, cap_height, hasher_kind)


class ShardedOracle:
    """The commit factory that prove_with_traces_device takes as `oracle`:
    commits run on the mesh; its `mesh` also shards the quotient classes,
    the FRI folds and the FRI trees."""

    def __init__(self, mesh):
        self.mesh = mesh

    def from_values(self, values, rate_bits, cap_height, hasher_kind="blake3"):
        return sharded_batch_from_values(self.mesh, values, rate_bits,
                                         cap_height, hasher_kind)

    def from_coeffs(self, coeffs, rate_bits, cap_height, hasher_kind="blake3"):
        return sharded_batch_from_coeffs(self.mesh, coeffs, rate_bits,
                                         cap_height, hasher_kind)


# ---------------------------------------------------------------------------
# the row-sharded constraint evaluation
# ---------------------------------------------------------------------------


def quotient_eval_fn(mesh, stark, alphas: list[int]):
    """Row-block-sharded evaluation of `stark.eval_packed` over coset
    points, accumulated with `alphas` and times the Z_H inverse column, as
    the single-device quotient runs it: the table's K6 slices
    (stark/constraint_codegen.py) on a card, their plain version on the
    CPU.

    The returned fn(local, nxt, z_last, lagrange_first, lagrange_last,
    zh_inv) takes (R, C) trace windows at x and g*x and (R,) selector and
    Z_H^{-1} columns, the same on every rank; each rank evaluates its
    contiguous R/W rows, the next row of each taken from `nxt` (across its
    block's end too), and one all_gather gives every rank the len(alphas)
    (R,) columns."""
    from ..stark import constraint_codegen as cg
    from ..stark import constraint_tape as ct
    from ..stark import prover_device

    C = stark.COLUMNS
    # emit_constraints with no permutation or CTL column: eval_packed alone
    k6 = prover_device.quotient_kernels(
        stark, C, 0, num_alphas=len(alphas), perm_meta=(), ctl_views=[],
        ctl_offsets=(), num_permutation_zs=0)

    def fn(local, nxt, z_last, lagrange_first, lagrange_last, zh_inv):
        device = local.device
        bank = gf.from_u64(alphas, device)
        pool = gf.from_u64(k6.tape.pool, device)

        def rows(lo, hi):
            no_zs = gf.zeros((0, hi - lo), device)
            return cg.evaluate(k6, ct.Inputs(
                local[lo:hi, :C].T, nxt[lo:hi, :C].T, no_zs, no_zs, 0,
                torch.stack([z_last[lo:hi], lagrange_first[lo:hi],
                             lagrange_last[lo:hi]]),
                bank, pool, zh_inv[lo:hi]))

        return list(shard_map_cat(mesh, "quotient", local.shape[0], rows,
                                  dim=1))

    return fn


# ---------------------------------------------------------------------------
# the prove and the launcher
# ---------------------------------------------------------------------------


def prove_with_traces_sharded(ola_stark, config, trace_poly_values,
                              public_values=None, timing=None, mesh=None,
                              device="cuda"):
    """The sharded prove, called on every rank of an initialised process
    group; every rank returns the same AllProof, byte-equal to the
    single-device prover's. `mesh=None` builds one from config.mesh, or
    over the whole group on `device`'s type. The group's backend must be
    the one config.mesh names (None: nccl on cards, gloo on the CPU); a
    failed NCCL group is never replaced by gloo. Without a card the default
    device raises."""
    from ..stark.config import MeshConfig
    from ..stark.prover_device import prove_with_traces_device

    device = torch.device(device)
    mesh_config = config.mesh or MeshConfig(device_type=device.type)
    if mesh is None:
        mesh = mesh_config.build_mesh()
    if mesh.device_type != device.type:
        raise ValueError(f"the mesh is on {mesh.device_type!r}, the prove on "
                         f"{device.type!r}")
    want = mesh_config.backend or default_backend(mesh.device_type)
    if dist.get_backend() != want:
        raise RuntimeError(f"the process group runs {dist.get_backend()!r}, "
                           f"the mesh configuration asks for {want!r}")
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return prove_with_traces_device(
        ola_stark, config, trace_poly_values, public_values=public_values,
        timing=timing, device=device, oracle=ShardedOracle(mesh))


def _toy_system():
    """The port's ToySystem module (tests/torch_toy_system.py), found
    through the repository's tests directory, which goes on sys.path once.
    It imports neither pytest nor anything that changes torch's threads."""
    import sys

    tests_dir = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))), "tests")
    if tests_dir not in sys.path:
        sys.path.insert(0, tests_dir)
    import torch_toy_system

    return torch_toy_system


def _dryrun_rank(config) -> bytes:
    """One rank of dryrun_prove_step: the sharded prove of ToySystem at
    degree 64, serialized."""
    from ..stark.serialization import serialize_all_proof

    toy = _toy_system()
    proof = prove_with_traces_sharded(toy.ToySystem(), config,
                                      toy.build_traces(64),
                                      device=config.mesh.device_type)
    return serialize_all_proof(proof)


def dryrun_prove_step(n_devices: int, config=None) -> None:
    """One sharded prove of ToySystem (degree 64) on `n_devices` ranks
    spawned by run_ranks, then the same prove on one device in this
    process, asserting that every rank's proof serializes to the
    single-device bytes and that the proof verifies; the counterpart of
    olavm_tpu/parallel/sharded.py's dryrun_prove_step. ToySystem is the
    port's own (tests/torch_toy_system.py). `config` None is
    standard_fast_config. The ranks and the single-device prove run on
    `config.mesh.device_type`; where the config names no mesh, on the
    cards, one rank per card (NCCL), and without a card it raises before
    any rank starts: the CPU is asked for with a config whose mesh is
    MeshConfig(device_type="cpu") (gloo ranks). On the cards, n_devices may
    not exceed the cards present (NCCL refuses two ranks on one card)."""
    import dataclasses

    from ..stark.config import MeshConfig, StarkConfig
    from ..stark.prover_device import prove_with_traces_device
    from ..stark.serialization import deserialize_all_proof, serialize_all_proof
    from ..stark.verifier import verify_proof

    config = config or StarkConfig.standard_fast_config()
    if config.mesh is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "dryrun_prove_step: no CUDA device is available; pass a "
                "config with mesh=MeshConfig(device_type=\"cpu\") to run "
                "the ranks on the host")
        config = dataclasses.replace(config, mesh=MeshConfig(
            device_type="cuda"))
    device_type = config.mesh.device_type
    if device_type == "cuda" and n_devices > torch.cuda.device_count():
        raise ValueError(
            f"dryrun_prove_step: {n_devices} ranks need {n_devices} cards, "
            f"{torch.cuda.device_count()} present (one rank per card)")
    ranks = run_ranks(_dryrun_rank, n_devices, config.mesh.backend,
                      device_type, config)
    toy = _toy_system()
    single = serialize_all_proof(prove_with_traces_device(
        toy.ToySystem(), config, toy.build_traces(64), device=device_type))
    for rank, data in enumerate(ranks):
        assert data == single, (
            f"rank {rank}'s sharded proof ({len(data)} B) != single-device "
            f"proof ({len(single)} B)")
    verify_proof(toy.ToySystem(), deserialize_all_proof(ranks[0]), config)
    print(f"dryrun_multichip OK: mesh={mesh_shape(n_devices)} on "
          f"{device_type}, proof_bytes={len(single)}, "
          f"proof-bytes-equal=True, verified=True")


def run_ranks(fn, world: int, backend: str | None = None,
              device_type: str = "cuda", *args) -> list:
    """Spawn `world` processes, rank r running fn(*args) in a process group
    of `backend` (None: default_backend(device_type)) on `device_type`, and
    return every rank's result in rank order. The group meets through a
    file:// rendezvous in a temporary directory (no network port); each rank
    has LOCAL_RANK = its rank, 1/world of the host's cores for torch's
    threads and, on "cuda", the card rank % cards. A rank
    that raises fails the call with its traceback. `fn` and `args` are
    pickled (spawn): fn must be importable, and large inputs go by file.
    Raises without a card when device_type is "cuda"."""
    import torch.multiprocessing as mp

    if device_type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("run_ranks: no CUDA device is available; pass "
                           "device_type=\"cpu\" to run the ranks on the host")
    backend = backend or default_backend(device_type)
    with tempfile.TemporaryDirectory() as tmp:
        mp.start_processes(_rank_main, nprocs=world, start_method="spawn",
                           args=(fn, world, backend, device_type, tmp, args))
        results = []
        for rank in range(world):
            with open(os.path.join(tmp, f"rank{rank}.pkl"), "rb") as f:
                results.append(pickle.load(f))
    return results


def _rank_main(rank, fn, world, backend, device_type, tmp, args):
    os.environ["LOCAL_RANK"] = str(rank)
    # the ranks share the host: each takes its share of the cores (torch's
    # default, every core in every rank, leaves them waiting on each other)
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
    if device_type == "cuda":
        torch.cuda.set_device(rank % torch.cuda.device_count())
    dist.init_process_group(
        backend, init_method="file://" + os.path.join(tmp, "rendezvous"),
        world_size=world, rank=rank, timeout=COLLECTIVE_TIMEOUT)
    try:
        out = fn(*args)
    finally:
        dist.destroy_process_group()
    path = os.path.join(tmp, f"rank{rank}.pkl")
    with open(path + ".part", "wb") as f:
        pickle.dump(out, f)
    os.replace(path + ".part", path)
