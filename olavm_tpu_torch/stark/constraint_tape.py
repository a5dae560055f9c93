"""A table's quotient constraints recorded as a tape of field operations.

The device prover's quotient (stark/prover_device.py quotient_class) runs
each table's constraint code (eval_packed, the permutation checks, the CTL
checks, each constraint through ConstraintConsumer's row filters) over the
coset values of one residue class. `record` runs that same code once
through TapeOps, whose values are symbolic nodes, and returns its tape:

- inputs: `lv[c]` (trace column c at row i), `nv[c]` (at row i+1 mod n),
  `zl[c]` and `zn[c]` (the Z columns likewise), the selector columns
  `sel[0..2]` (z_last, lagrange_first, lagrange_last) and the scalars
  `bank[k]` of the challenge bank (prover_device.quotient_bank);
- every host integer the code passes (F.constant, scalar_mul's factor,
  indicator_eq_const's value) as a slot of a constant pool, passed at
  launch: the tape's structure depends on no value, so one structure
  serves every program's compress challenges and every prove's challenges;
- operations add, sub, mul, neg and ieq (1 where a value equals a pooled
  constant, else 0), in SSA form, each node after its operands;
- outputs: the constraint sequence, in the consumer's order, each already
  multiplied by its row filter.

The quotient of the class is then, per alpha k (bank[k]), the Horner sum
acc_k = sum_j c_j alpha_k^(K-1-j) over the K constraints, times Z_H^{-1}:
ConstraintConsumer's value (it groups the same sum by 16; the field is
exact, so any grouping gives the same bits). `slices` cuts the sequence
into runs [a, b) whose operations stay under a budget; a slice updates
acc_k <- acc_k alpha_k^(b-a) + sum_{a<=j<b} c_j alpha_k^(b-1-j) by Horner
steps, so the slices in turn give the whole sum (olavm_tpu's `qpart`
programs and their `qfin` identity, olavm_tpu/stark/prover_device.py:155-167).
Each slice is one kernel on the card (stark/constraint_codegen.py, K6);
`evaluate_plain` is the same slices with gf's plain operations, the
kernels' plain version.

A value of the tape supports the Ops interface and nothing else: any
other use of a node (arithmetic operators, comparison, truth, conversion
to a number or an array) raises, so a table that evaluates its
constraints some other way is found where it is recorded, on the CPU.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import torch

from ..field import gf
from ..field import goldilocks as g

# the selector columns' positions in the `sel` input
Z_LAST, LAGRANGE_FIRST, LAGRANGE_LAST = 0, 1, 2
INPUT_KINDS = ("lv", "nv", "zl", "zn", "sel", "bank")
BINARY = ("add", "sub", "mul")
# operations of a slice's cone that compute (inputs and constants load)
COMPUTE = ("add", "sub", "mul", "neg", "ieq")
# the most computing operations one slice's kernel evaluates (its cone),
# unless one constraint alone needs more
SLICE_OPS = 1200


class Node:
    """One value of a tape; supports no operation of its own."""

    __slots__ = ("tape", "index")

    def __init__(self, tape: "Tape", index: int):
        self.tape = tape
        self.index = index

    def _refuse(self, *args, **kwargs):
        raise TypeError(
            "a constraint tape value supports only the Ops interface (add, "
            "sub, mul, neg, constant, scalar_mul, add_many, "
            "indicator_eq_const); this table's constraint code used it "
            "some other way")

    __add__ = __radd__ = __sub__ = __rsub__ = __mul__ = __rmul__ = _refuse
    __neg__ = __pos__ = __pow__ = __mod__ = _refuse
    __truediv__ = __floordiv__ = _refuse
    __and__ = __or__ = __xor__ = __lshift__ = __rshift__ = __invert__ = _refuse
    __eq__ = __ne__ = __lt__ = __le__ = __gt__ = __ge__ = _refuse
    __bool__ = __int__ = __index__ = __float__ = __len__ = __iter__ = _refuse
    __getitem__ = __array__ = __torch_function__ = _refuse
    __hash__ = object.__hash__


@dataclass
class Tape:
    """ops[i] = (kind, a, b): an input (kind in INPUT_KINDS, its index), a
    pooled constant ("const", pool slot), add/sub/mul (operand nodes), neg
    (operand), ieq (operand, pool slot). `outputs` are the constraint
    nodes in order; `pool` the constant values."""

    num_alphas: int
    ops: list = field(default_factory=list)
    pool: list = field(default_factory=list)
    outputs: list = field(default_factory=list)
    _inputs: dict = field(default_factory=dict, repr=False)
    # evaluate_plain's plan of each slice (a, b)
    _plans: dict = field(default_factory=dict, repr=False)

    def input(self, kind: str, index: int) -> Node:
        key = (kind, index)
        if key not in self._inputs:
            self._inputs[key] = self.emit(kind, index)
        return self._inputs[key]

    def emit(self, kind: str, a: int, b: int | None = None) -> Node:
        self.ops.append((kind, a, b))
        return Node(self, len(self.ops) - 1)

    def pooled(self, value) -> int:
        self.pool.append(int(value) % g.P)
        return len(self.pool) - 1


class TapeOps:
    """The Ops interface (stark/ops.py TorchOps) recording into a tape."""

    is_ext = False

    def __init__(self, tape: Tape):
        self.tape = tape

    def _id(self, x) -> int:
        if not isinstance(x, Node) or x.tape is not self.tape:
            raise TypeError(f"constraint tape operand of type "
                            f"{type(x).__name__}, not a value of this tape")
        return x.index

    def add(self, a, b):
        return self.tape.emit("add", self._id(a), self._id(b))

    def sub(self, a, b):
        return self.tape.emit("sub", self._id(a), self._id(b))

    def mul(self, a, b):
        return self.tape.emit("mul", self._id(a), self._id(b))

    def neg(self, a):
        return self.tape.emit("neg", self._id(a))

    def constant(self, c: int):
        return self.tape.emit("const", self.tape.pooled(c))

    def scalar_mul(self, a, c: int):
        # TorchOps skips the product for 0 and 1; the pooled product has
        # the same value and the same structure for every c
        return self.mul(a, self.constant(c))

    def add_many(self, terms):
        acc = terms[0]
        for t in terms[1:]:
            acc = self.add(acc, t)
        return acc

    def indicator_eq_const(self, a, c: int):
        return self.tape.emit("ieq", self._id(a), self.tape.pooled(c))


class _Bank:
    """The challenge bank as the constraint code indexes it."""

    def __init__(self, tape: Tape):
        self.tape = tape

    def __getitem__(self, k: int) -> Node:
        return self.tape.input("bank", int(k))


class _Recorder:
    """ConstraintConsumer's interface: each constraint, after its row
    filter, is the tape's next output."""

    def __init__(self, F: TapeOps):
        tape = F.tape
        self.F = F
        self.z_last = tape.input("sel", Z_LAST)
        self.lagrange_first = tape.input("sel", LAGRANGE_FIRST)
        self.lagrange_last = tape.input("sel", LAGRANGE_LAST)

    def constraint(self, c):
        self.F.tape.outputs.append(self.F._id(c))

    def constraint_transition(self, c):
        self.constraint(self.F.mul(c, self.z_last))

    def constraint_first_row(self, c):
        self.constraint(self.F.mul(c, self.lagrange_first))

    def constraint_last_row(self, c):
        self.constraint(self.F.mul(c, self.lagrange_last))


def record(emit, n_cols: int, n_zs: int, num_alphas: int) -> Tape:
    """The tape of `emit(consumer, F, lv, nv, zl, zn, bank)`, the
    constraint code of one table (prover_device.emit_constraints), over
    `n_cols` trace and `n_zs` Z columns, its alphas bank[0..num_alphas)."""
    tape = Tape(num_alphas)
    F = TapeOps(tape)
    lv = [tape.input("lv", c) for c in range(n_cols)]
    nv = [tape.input("nv", c) for c in range(n_cols)]
    zl = [tape.input("zl", c) for c in range(n_zs)]
    zn = [tape.input("zn", c) for c in range(n_zs)]
    emit(_Recorder(F), F, lv, nv, zl, zn, _Bank(tape))
    for k in range(num_alphas):
        tape.input("bank", k)
    if not tape.outputs:
        raise ValueError("the constraint code emitted no constraint")
    return tape


def operands(op) -> tuple:
    """The operand nodes of one tape operation."""
    kind, a, b = op
    if kind in BINARY:
        return a, b
    if kind in ("neg", "ieq"):
        return (a,)
    return ()


def cone(tape: Tape, outputs, seen: set | None = None) -> set:
    """The nodes that `outputs` need (themselves included), beyond `seen`."""
    seen = set() if seen is None else seen
    new = set()
    stack = [o for o in outputs if o not in seen]
    while stack:
        i = stack.pop()
        if i in seen or i in new:
            continue
        new.add(i)
        stack.extend(j for j in operands(tape.ops[i])
                     if j not in seen and j not in new)
    return new


def slices(tape: Tape, budget: int = SLICE_OPS) -> list[tuple[int, int]]:
    """The constraint sequence cut into runs [a, b) whose cones hold at
    most `budget` computing operations each (a run of one constraint may
    hold more)."""
    out, start, seen, ops = [], 0, set(), 0
    for j, o in enumerate(tape.outputs):
        new = cone(tape, [o], seen)
        n = sum(tape.ops[i][0] in COMPUTE for i in new)
        if j > start and ops + n > budget:
            out.append((start, j))
            start, seen, ops = j, set(), 0
            new = cone(tape, [o], seen)
            n = sum(tape.ops[i][0] in COMPUTE for i in new)
        seen |= new
        ops += n
    out.append((start, len(tape.outputs)))
    return out


def slice_ops(tape: Tape, a: int, b: int) -> dict:
    """Computing operations of slice [a, b)'s kernel, by kind, with its
    Horner steps (a product and a sum per constraint and alpha) and the
    last slice's Z_H^{-1} product counted as mul and add."""
    out = dict.fromkeys(COMPUTE, 0)
    for i in cone(tape, tape.outputs[a:b]):
        kind = tape.ops[i][0]
        if kind in out:
            out[kind] += 1
    out["mul"] += (b - a) * tape.num_alphas
    out["add"] += (b - a) * tape.num_alphas
    if b == len(tape.outputs):
        out["mul"] += tape.num_alphas
    return out


def required_ops(tape: Tape) -> dict:
    """Computing operations per row that the quotient needs, by kind: the
    union cone of all constraints, each node once (slice_ops counts a node
    in every slice whose cone holds it, as the kernels recompute it),
    without the products by a pooled 0 or 1 (TorchOps skips them), and
    the Horner steps and the Z_H^{-1} product of one pass over the
    sequence."""
    out = dict.fromkeys(COMPUTE, 0)
    trivial = {i for i, (kind, a, _) in enumerate(tape.ops)
               if kind == "const" and tape.pool[a] in (0, 1)}
    for i in cone(tape, tape.outputs):
        kind, a, b = tape.ops[i]
        if kind == "mul" and (a in trivial or b in trivial):
            continue
        if kind in out:
            out[kind] += 1
    k = len(tape.outputs) * tape.num_alphas
    out["mul"] += k + tape.num_alphas
    out["add"] += k
    return out


@dataclass
class Inputs:
    """A class's values for the slices: lv, zl (C, m) and (Z, m) values;
    row i's next row is row (i + nshift) mod m of nv and zn; sel (3, m);
    bank and pool 1-D; zh_inv one value or (m,). Tensors on one device."""

    lv: torch.Tensor
    nv: torch.Tensor
    zl: torch.Tensor
    zn: torch.Tensor
    nshift: int
    sel: torch.Tensor
    bank: torch.Tensor
    pool: torch.Tensor
    zh_inv: torch.Tensor

    @property
    def rows(self) -> int:
        return self.sel.shape[1]


def _plan(tape: Tape, a: int, b: int) -> tuple:
    """Slice [a, b)'s cone for evaluate_plain: its nodes in order, the
    loads grouped by kind ({kind: (value rows, indices)}) and the computing
    nodes grouped by depth and kind ([(kind, value rows, operand rows,
    operand rows or pool slots)])."""
    need = sorted(cone(tape, tape.outputs[a:b]))
    row = {i: r for r, i in enumerate(need)}
    loads, depth, steps = {}, {}, {}
    for i in need:
        kind, x, y = tape.ops[i]
        if kind in INPUT_KINDS or kind == "const":
            rows, idx = loads.setdefault(kind, ([], []))
            rows.append(row[i])
            idx.append(x)
            depth[i] = 0
            continue
        ops = operands(tape.ops[i])
        depth[i] = 1 + max(depth[j] for j in ops)
        rows, xs, ys = steps.setdefault((depth[i], kind), ([], [], []))
        rows.append(row[i])
        xs.append(row[x])
        ys.append(row[y] if kind in BINARY else y or 0)
    return (len(need), {k: (torch.tensor(r), torch.tensor(x))
                        for k, (r, x) in loads.items()},
            [(kind, torch.tensor(r), torch.tensor(x), torch.tensor(y))
             for (_, kind), (r, x, y) in sorted(steps.items())],
            torch.tensor([row[o] for o in tape.outputs[a:b]]))


def evaluate_plain(tape: Tape, cuts, inp: Inputs) -> torch.Tensor:
    """The kernels' plain version: each slice's cone with gf's plain
    operations (the nodes of one depth and kind at once), then its
    constraints into the accumulators, acc * alpha^(b-a) + sum_j c_j
    alpha^(b-1-j) (powers and sum by log-doubling: the kernels' Horner
    steps in another grouping, equal in the field), the last times Z_H^{-1}.
    Returns (num_alphas, m)."""
    m, device = inp.rows, inp.sel.device
    nxt = (torch.arange(m, device=device) + inp.nshift) % m
    sources = {"lv": inp.lv, "nv": inp.nv[:, nxt], "zl": inp.zl,
               "zn": inp.zn[:, nxt], "sel": inp.sel}
    alphas = inp.bank[:tape.num_alphas].reshape(-1, 1)
    accs = gf.zeros((tape.num_alphas, m), device)
    for a, b in cuts:
        if (a, b) not in tape._plans:
            tape._plans[a, b] = _plan(tape, a, b)
        size, loads, steps, outs = tape._plans[a, b]
        vals = torch.empty((size, m), dtype=torch.int64, device=device)
        for kind, (rows, idx) in loads.items():
            if kind in sources:
                vals[rows] = sources[kind][idx]
            else:  # bank or const: one value per row
                vals[rows] = (inp.bank if kind == "bank" else inp.pool)[
                    idx].reshape(-1, 1)
        for kind, rows, xs, ys in steps:
            x = vals[xs]
            if kind == "add":
                vals[rows] = gf.add_plain(x, vals[ys])
            elif kind == "sub":
                vals[rows] = gf.sub_plain(x, vals[ys])
            elif kind == "mul":
                vals[rows] = gf.mul_plain(x, vals[ys])
            elif kind == "neg":
                vals[rows] = gf.sub_plain(torch.zeros_like(x), x)
            else:  # ieq
                vals[rows] = (x == inp.pool[ys].reshape(-1, 1)).to(torch.int64)
        k = b - a
        # pw[:, t] = alpha^t for t <= k
        pw = torch.ones((tape.num_alphas, 1), dtype=torch.int64, device=device)
        while pw.shape[1] <= k:
            step = min(pw.shape[1], k + 1 - pw.shape[1])
            top = gf.mul_plain(pw[:, -1:], alphas)
            pw = torch.cat([pw, gf.mul_plain(pw[:, :step], top)], dim=1)
        terms = gf.mul_plain(vals[outs][None, :, :],
                             pw[:, :k].flip(1)[:, :, None])
        accs = gf.add_plain(gf.mul_plain(accs, pw[:, k:k + 1]),
                            _sum_plain(terms))
    return gf.mul_plain(accs, inp.zh_inv)


def _sum_plain(x: torch.Tensor) -> torch.Tensor:
    """Field sum over dim 1 by pairwise halving."""
    while x.shape[1] > 1:
        if x.shape[1] % 2:
            x = torch.cat([x, torch.zeros_like(x[:, :1])], dim=1)
        x = gf.add_plain(x[:, 0::2], x[:, 1::2])
    return x[:, 0]
