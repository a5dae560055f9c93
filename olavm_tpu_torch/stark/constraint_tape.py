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

The quotient of the class is then, per alpha k (bank[k]), the sum
acc_k = sum_j c_j alpha_k^(K-1-j) over the K constraints, times Z_H^{-1}:
ConstraintConsumer's value (it groups the same sum by 16, by Horner
steps; the field is exact, so any grouping gives the same bits).

`lower` folds the products by a pooled 0 or 1 (a slot is baked into the
kernels' text only where its value is 0 or 1, which no challenge is but
with negligible probability) and what they make trivial, and makes every
repeated operation once; the nodes that read no row (powers of a
challenge, say) are `uniform`, made once per class. `plan` cuts the
per-row nodes, depth first constraint by constraint, into slices of at
most SLICE_OPS operations and SLICE_LIVE values live at once; a value
that a later slice needs is recomputed there when cheap, else stored to
a scratch column once. Since each constraint carries its own power of
each alpha, a slice adds c_j alpha_k^(K-1-j) for the constraints it
computes, in any order. Each slice is one kernel on the card
(stark/constraint_codegen.py, K6); `evaluate_plain` is the same slices
with gf's plain operations, the kernels' plain version.

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
# the inputs with a value per row
ROW_INPUTS = ("lv", "nv", "zl", "zn", "sel")
BINARY = ("add", "sub", "mul")
# operations of a slice's cone that compute (inputs and constants load)
COMPUTE = ("add", "sub", "mul", "neg", "ieq")
# the most computing operations of the lowered graph that one slice's
# kernel owns, and the most values its row function holds live at once
# (chip_kernel_times.py --kernel quotient sweeps both; with REUSE, LEAD and
# constraints.cuh's MIN_BLOCKS these gave no spill in any table and the
# fastest CpuStark class, PERF.md)
SLICE_OPS = 200
SLICE_LIVE = 24
# a loaded value is read again where more than this many nodes of its
# slice passed since its last use, rather than held in a register; a load
# issues once the value computed LEAD nodes before its use is known
REUSE = 16
LEAD = 8
# a value that a later slice needs is recomputed there when that costs at
# most this many operations, else stored to a scratch column
RECOMPUTE_OPS = 3


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


@dataclass
class Graph:
    """A tape lowered for the kernels (`lower`): ops[i] = (kind, a, b) as in
    a Tape, and ("lit", value, None), a value baked into the kernels'
    text; `outputs` the node of each constraint; `folded` the pool slots
    whose value (0 or 1) the text bakes in. `uniform` the computing nodes
    that read no row (only the bank, the pool and baked values: powers of
    a challenge, say), made once per class, in order; `published` those of
    them that the rows read."""

    num_alphas: int
    ops: list
    outputs: list
    folded: dict
    uniform: list = field(init=False)
    published: list = field(init=False)
    # the computing nodes made for each row
    per_row: set = field(init=False, repr=False)

    def __post_init__(self):
        uniform, self.per_row = set(), set()
        for i, op in enumerate(self.ops):
            if op[0] in COMPUTE:
                if all(self.ops[x][0] in ("bank", "const", "lit")
                       or x in uniform for x in operands(op)):
                    uniform.add(i)
                else:
                    self.per_row.add(i)
        needed = cone(self, self.outputs)
        read = {x for i in needed & self.per_row
                for x in operands(self.ops[i])} | set(self.outputs)
        self.published = sorted(read & uniform)
        self.uniform = sorted(cone(self, self.published) & uniform)


def lower(tape: Tape) -> Graph:
    """The tape with its products by a pooled 0 or 1 folded (x*1 = x,
    x*0 = 0), and whatever a 0 makes trivial after that (x+0, x-0, 0-x as
    a negation, sums and products of baked values), and every operation
    that repeats one already made (the same kind on the same operands)
    made once. A pool slot is baked in only where its value is 0 or 1, so
    a compress challenge or a prove's challenges (never 0 or 1 but with
    negligible probability, and then only another build) leave the text
    as it is."""
    ops, memo, ref, folded = [], {}, [], {}

    def node(kind, a, b=None):
        if kind in ("add", "mul") and a > b:
            a, b = b, a
        key = (kind, a, b)
        if key not in memo:
            ops.append(key)
            memo[key] = len(ops) - 1
        return memo[key]

    def lit(i):
        kind, a, _ = ops[i]
        return a if kind == "lit" else None

    for kind, a, b in tape.ops:
        if kind == "const" and tape.pool[a] in (0, 1):
            folded[a] = tape.pool[a]
            r = node("lit", tape.pool[a])
        elif kind in INPUT_KINDS or kind == "const":
            r = node(kind, a)
        elif kind in BINARY:
            x, y = ref[a], ref[b]
            lx, ly = lit(x), lit(y)
            if lx is not None and ly is not None:
                r = node("lit", {"add": g.add, "sub": g.sub,
                                 "mul": g.mul}[kind](lx, ly))
            elif kind == "mul" and 0 in (lx, ly):
                r = node("lit", 0)
            elif kind == "mul" and 1 in (lx, ly):
                r = y if lx == 1 else x
            elif kind == "add" and 0 in (lx, ly):
                r = y if lx == 0 else x
            elif kind == "sub" and ly == 0:
                r = x
            elif kind == "sub" and lx == 0:
                r = node("neg", y)
            elif kind == "sub" and x == y:
                r = node("lit", 0)
            else:
                r = node(kind, x, y)
        elif kind == "neg":
            x = ref[a]
            if lit(x) is not None:
                r = node("lit", g.sub(0, lit(x)))
            elif ops[x][0] == "neg":
                r = ops[x][1]
            else:
                r = node("neg", x)
        else:  # ieq: its slot is compared at run time, never baked in
            r = node("ieq", ref[a], b)
        ref.append(r)
    return Graph(tape.num_alphas, ops, [ref[o] for o in tape.outputs],
                 folded)


@dataclass
class Slice:
    """One kernel of a plan: `nodes` the computing nodes it evaluates in
    order (its share of the graph, and the small cones it recomputes),
    `loads` the nodes it reads from scratch columns that earlier slices
    wrote, `stores` those of its nodes that later slices read, `terms`
    (constraint j, node) for the constraints it adds into the
    accumulators."""

    nodes: list = field(default_factory=list)
    loads: list = field(default_factory=list)
    stores: list = field(default_factory=list)
    terms: list = field(default_factory=list)


@dataclass
class Plan:
    """A graph's slices, in launch order, and the scratch column of each
    stored node (columns are reused once their last reader has run)."""

    graph: Graph
    slices: list
    columns: dict
    # evaluate_plain's plan of each slice
    _plain: dict = field(default_factory=dict, repr=False)

    @property
    def scratch(self) -> int:
        return max(self.columns.values(), default=-1) + 1


def _computing(graph: Graph, i: int) -> bool:
    """Computed for each row (a uniform node is a constant of the rows)."""
    return i in graph.per_row


def _post_order(graph: Graph) -> list:
    """The computing nodes of every constraint's cone, each after its
    operands: depth first, constraint by constraint."""
    seen, order = set(), []
    for o in graph.outputs:
        stack = [(o, False)]
        while stack:
            i, done = stack.pop()
            if done:
                if _computing(graph, i):
                    order.append(i)
                continue
            if i in seen:
                continue
            seen.add(i)
            stack.append((i, True))
            stack.extend((x, False) for x in reversed(operands(graph.ops[i]))
                         if x not in seen)
    return order


def plan(graph: Graph, budget: int = SLICE_OPS, live: int = SLICE_LIVE,
         recompute: int = RECOMPUTE_OPS) -> Plan:
    """Cut the graph's computing nodes, in depth-first order, into slices
    of at most `budget` nodes each, and cut a slice in two again while
    more than `live` of its values are live at once (`pressure`): every
    node has one slice that computes it. A value that a later slice needs
    is recomputed there when its cone (beyond what that slice holds or
    loads) has at most `recompute` operations, else its slice stores it to
    a scratch column and the later slices load it. Each constraint enters
    the accumulators in the slice that computes it (its own power of alpha
    makes the order free); a constraint folded to 0 enters nowhere."""
    order = _post_order(graph)
    starts = list(range(0, len(order), budget)) or [0]
    while True:
        slices, home, last_reader = _cut(graph, order, starts, recompute)
        ends = starts[1:] + [len(order)]
        split = [(a + b) // 2 for sl, a, b in zip(slices, starts, ends)
                 if b - a > 1 and pressure(graph, sl) > live]
        if not split:
            break
        starts = sorted(starts + split)
    for v in order:
        if v in last_reader:
            slices[home[v]].stores.append(v)
    for j, o in enumerate(graph.outputs):
        if graph.ops[o] != ("lit", 0, None):
            slices[home.get(o, 0)].terms.append((j, o))
    # a column is free again after its value's last reader
    columns, free_after = {}, []
    position = {v: n for n, v in enumerate(order)}
    for v in sorted(last_reader, key=position.get):
        col = next((c for c, t in enumerate(free_after) if t < home[v]),
                   len(free_after))
        if col == len(free_after):
            free_after.append(0)
        free_after[col] = last_reader[v]
        columns[v] = col
    return Plan(graph, slices, columns)


def _cut(graph: Graph, order: list, starts: list, recompute: int) -> tuple:
    """The slices of `order` cut at `starts`: each slice's nodes (its own,
    and the small cones it recomputes) and loads; the slice of each node
    and the last slice that reads each stored node."""
    home, own = {}, []
    for s, (a, b) in enumerate(zip(starts, starts[1:] + [len(order)])):
        own.append(order[a:b])
        for v in own[-1]:
            home[v] = s
    slices = [Slice() for _ in starts]
    last_reader = {}

    for s, sl in enumerate(slices):
        have = set()

        def cost(v):
            # operations to recompute v here: its cone up to what the
            # slice holds and what is stored
            n, seen, stack = 0, set(), [v]
            while stack:
                x = stack.pop()
                if (x in seen or x in have or x in last_reader
                        or not _computing(graph, x)):
                    continue
                seen.add(x)
                n += 1
                stack.extend(operands(graph.ops[x]))
            return n

        def ensure(v):
            if v in have or not _computing(graph, v):
                return
            assert home[v] < s, "a slice's own node out of order"
            if v in last_reader or cost(v) > recompute:
                last_reader[v] = s
                sl.loads.append(v)
            else:
                for x in operands(graph.ops[v]):
                    ensure(x)
                sl.nodes.append(v)
            have.add(v)

        for v in own[s]:
            for x in operands(graph.ops[v]):
                ensure(x)
            sl.nodes.append(v)
            have.add(v)
    return slices, home, last_reader


def pressure(graph: Graph, sl: Slice) -> int:
    """The most values of a slice's row function live at once, its nodes
    in order (the rows' inputs, the loaded and the computed values; the
    pool, the bank, baked and uniform values are constants): a computed
    value from its node to its last use, a loaded one from its first use
    to its last (and LEAD nodes before, as it is loaded ahead), but read
    again where more than REUSE nodes passed since its last use (the
    kernels do: constraint_codegen)."""
    uses = {}
    for t, v in enumerate(sl.nodes):
        for x in operands(graph.ops[v]):
            if graph.ops[x][0] in ROW_INPUTS or _computing(graph, x):
                uses.setdefault(x, []).append(t)
        uses.setdefault(v, []).append(t)
    loaded = set(sl.loads)
    spans = []
    for x, ts in uses.items():
        load = x in loaded or graph.ops[x][0] in ROW_INPUTS
        ahead = LEAD if load else 0
        start = prev = ts[0]
        for t in ts[1:]:
            if t - prev > REUSE and load:
                spans.append((start - ahead, prev))
                start = t
            prev = t
        spans.append((start - ahead, prev))
    events = sorted([(a, 1) for a, _ in spans] + [(b + 0.5, -1)
                                                  for _, b in spans])
    n = most = 0
    for _, d in events:
        n += d
        most = max(most, n)
    return most


def _kinds(graph: Graph, nodes) -> dict:
    out = dict.fromkeys(COMPUTE, 0)
    for i in nodes:
        kind = graph.ops[i][0]
        if kind in out:
            out[kind] += 1
    return out


def _accumulate(out: dict, graph: Graph, terms: int) -> dict:
    # each constraint times its power of each alpha into the accumulators,
    # and the Z_H^{-1} product
    out["mul"] += terms * graph.num_alphas + graph.num_alphas
    out["add"] += terms * graph.num_alphas
    return out


def required_ops(graph: Graph) -> dict:
    """Computing operations per row that the quotient needs, by kind: the
    union cone of all constraints of the lowered graph (each distinct
    operation once, no product by a pooled 0 or 1, none that reads no
    row), and per constraint that is not 0 and per alpha a product by its
    power and a sum, with the Z_H^{-1} product."""
    terms = sum(graph.ops[o] != ("lit", 0, None) for o in graph.outputs)
    needed = [i for i in cone(graph, graph.outputs) if _computing(graph, i)]
    return _accumulate(_kinds(graph, needed), graph, terms)


def plan_ops(p: Plan) -> dict:
    """Computing operations per row that the plan's slices run, by kind
    (recomputed nodes in each slice that runs them), with the same
    accumulator steps as required_ops."""
    out = dict.fromkeys(COMPUTE, 0)
    for sl in p.slices:
        for kind, n in _kinds(p.graph, sl.nodes).items():
            out[kind] += n
    return _accumulate(out, p.graph, sum(len(sl.terms) for sl in p.slices))


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


def _slice_plain(graph: Graph, sl: Slice, columns: dict) -> tuple:
    """A slice for evaluate_plain: its values' rows, the loads grouped by
    kind ({kind: (value rows, indices)}: inputs, pool slots, baked values,
    scratch columns), its computing nodes grouped by depth and kind ([(kind,
    value rows, operand rows, operand rows or pool slots)]), and the rows
    of its terms and its stores."""
    row = {}
    loads, depth, steps = {}, {}, {}

    def leaf(i):
        if i in row:
            return
        row[i] = len(row)
        depth[i] = 0
        kind, x, _ = graph.ops[i]
        if i in columns and _computing(graph, i):
            kind, x = "scratch", columns[i]
        elif kind in COMPUTE:  # a uniform node
            kind, x = "uniform", i
        elif kind == "lit":  # the int64 of its 64-bit word
            x -= (x >> 63) << 64
        rows, idx = loads.setdefault(kind, ([], []))
        rows.append(row[i])
        idx.append(x)

    for i in sl.loads:
        leaf(i)
    for i in sl.nodes:
        kind, x, y = graph.ops[i]
        ops = operands(graph.ops[i])
        for j in ops:
            if j not in row:
                leaf(j)
        row[i] = len(row)
        depth[i] = 1 + max(depth[j] for j in ops)
        rows, xs, ys = steps.setdefault((depth[i], kind), ([], [], []))
        rows.append(row[i])
        xs.append(row[x])
        ys.append(row[y] if kind in BINARY else y or 0)
    for _, o in sl.terms:
        if o not in row:
            leaf(o)
    return (len(row), {k: (torch.tensor(r), torch.tensor(x))
                       for k, (r, x) in loads.items()},
            [(kind, torch.tensor(r), torch.tensor(x), torch.tensor(y))
             for (_, kind), (r, x, y) in sorted(steps.items())],
            torch.tensor([row[o] for _, o in sl.terms], dtype=torch.int64),
            torch.tensor([j for j, _ in sl.terms], dtype=torch.int64),
            [(columns[v], row[v]) for v in sl.stores])


def alpha_powers_plain(alphas: torch.Tensor, k: int) -> torch.Tensor:
    """(len(alphas), k): alpha^t for t < k, by log-doubling with the plain
    product."""
    pw = torch.ones((alphas.numel(), 1), dtype=torch.int64,
                    device=alphas.device)
    alphas = alphas.reshape(-1, 1)
    while pw.shape[1] < k:
        step = min(pw.shape[1], k - pw.shape[1])
        top = gf.mul_plain(pw[:, -1:], alphas)
        pw = torch.cat([pw, gf.mul_plain(pw[:, :step], top)], dim=1)
    return pw[:, :k]


def evaluate_plain(p: Plan, inp: Inputs) -> torch.Tensor:
    """The kernels' plain version: each slice in turn with gf's plain
    operations (the nodes of one depth and kind at once), its loads and
    stores through a dictionary of scratch columns, its constraints c_j
    times alpha_k^(K-1-j) into the accumulators; at the end times
    Z_H^{-1}. The sum over all K constraints is ConstraintConsumer's value
    (the field is exact: any grouping gives the same bits). Returns
    (num_alphas, m)."""
    graph = p.graph
    m, device = inp.rows, inp.sel.device
    nxt = (torch.arange(m, device=device) + inp.nshift) % m
    sources = {"lv": inp.lv, "nv": inp.nv[:, nxt], "zl": inp.zl,
               "zn": inp.zn[:, nxt], "sel": inp.sel}
    k = len(graph.outputs)
    # pw[:, K-1-j] is constraint j's power of each alpha
    pw = alpha_powers_plain(inp.bank[:graph.num_alphas], k).flip(1)
    accs = gf.zeros((graph.num_alphas, m), device)
    uniform = _uniform_plain(graph, inp)
    scratch = {}
    for s, sl in enumerate(p.slices):
        if s not in p._plain:
            p._plain[s] = _slice_plain(graph, sl, p.columns)
        size, loads, steps, outs, js, stores = p._plain[s]
        vals = torch.empty((size, m), dtype=torch.int64, device=device)
        for kind, (rows, idx) in loads.items():
            if kind in sources:
                vals[rows] = sources[kind][idx]
            elif kind == "scratch":
                vals[rows] = torch.stack([scratch[c] for c in idx.tolist()])
            elif kind == "uniform":
                vals[rows] = torch.stack([uniform[i] for i in idx.tolist()])
            else:  # bank, pool or baked: one value per row
                table = {"bank": inp.bank, "const": inp.pool}.get(kind)
                vals[rows] = (idx.to(device) if table is None
                              else table[idx]).reshape(-1, 1)
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
        for col, r in stores:
            scratch[col] = vals[r]
        if len(outs):
            terms = gf.mul_plain(vals[outs][None, :, :], pw[:, js, None])
            accs = gf.add_plain(accs, _sum_plain(terms))
    return gf.mul_plain(accs, inp.zh_inv)


def _uniform_plain(graph: Graph, inp: Inputs) -> dict:
    """The uniform nodes' values, each a 1-element tensor."""
    out = {}

    def value(i):
        kind, x, _ = graph.ops[i]
        if kind == "bank":
            return inp.bank[x:x + 1]
        if kind == "const":
            return inp.pool[x:x + 1]
        if kind == "lit":
            return gf.from_u64([x], inp.bank.device)
        return out[i]

    for i in graph.uniform:
        kind, a, b = graph.ops[i]
        x = value(a)
        if kind == "add":
            out[i] = gf.add_plain(x, value(b))
        elif kind == "sub":
            out[i] = gf.sub_plain(x, value(b))
        elif kind == "mul":
            out[i] = gf.mul_plain(x, value(b))
        elif kind == "neg":
            out[i] = gf.sub_plain(torch.zeros_like(x), x)
        else:  # ieq
            out[i] = (x == inp.pool[b:b + 1]).to(torch.int64)
    return out


def _sum_plain(x: torch.Tensor) -> torch.Tensor:
    """Field sum over dim 1 by pairwise halving."""
    while x.shape[1] > 1:
        if x.shape[1] % 2:
            x = torch.cat([x, torch.zeros_like(x[:, :1])], dim=1)
        x = gf.add_plain(x[:, 0::2], x[:, 1::2])
    return x[:, 0]
