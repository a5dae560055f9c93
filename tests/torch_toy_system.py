"""ToySystem (tests/test_stark_framework.py) built from the port's classes,
so that code which needs it loads nothing of olavm_tpu or jax: the sharded
tests' ranks and parallel/sharded.py's dryrun_prove_step. It imports
neither pytest nor tests/torch_threads.py, so importing it leaves torch's
thread settings as they are. test_torch_sharded.py holds its proofs to
olavm_tpu's host prover on the original."""

import numpy as np

from olavm_tpu_torch.field import goldilocks as g
from olavm_tpu_torch.stark.cross_table_lookup import (
    Column,
    CrossTableLookup,
    TableWithColumns,
)
from olavm_tpu_torch.stark.stark_base import PermutationPair, Stark


class FibStark(Stark):
    """Columns: [a, b, c, c_rev]; a'=b, b'=a+b; c_rev is a permutation of c."""

    COLUMNS = 4

    def eval_packed(self, local, nxt, consumer):
        F = consumer.F
        consumer.constraint_first_row(F.sub(local[0], F.constant(1)))
        consumer.constraint_first_row(F.sub(local[1], F.constant(1)))
        consumer.constraint_transition(F.sub(nxt[0], local[1]))
        consumer.constraint_transition(F.sub(nxt[1], F.add(local[0], local[1])))

    def constraint_degree(self):
        return 3

    def permutation_pairs(self):
        return [PermutationPair.singletons(2, 3)]


class CopyStark(Stark):
    """Single column, no constraints of its own (CTL-bound to FibStark.a)."""

    COLUMNS = 1

    def eval_packed(self, local, nxt, consumer):
        pass

    def constraint_degree(self):
        return 3


class ToySystem:
    def __init__(self):
        self.starks = [FibStark(), CopyStark()]
        self.cross_table_lookups = [
            CrossTableLookup(
                looking_tables=[TableWithColumns(0, [Column.single(0)], None)],
                looked_table=TableWithColumns(1, [Column.single(0)], None),
            )
        ]

    def compress_challenges(self):
        return [0, 0]


def build_traces(n):
    a = np.zeros(n, dtype=np.uint64)
    b = np.zeros(n, dtype=np.uint64)
    a[0], b[0] = 1, 1
    for i in range(1, n):
        a[i] = b[i - 1]
        b[i] = g.add(int(a[i - 1]), int(b[i - 1]))
    rng = np.random.RandomState(0)
    c = rng.randint(0, 1 << 32, size=n).astype(np.uint64)
    return [np.stack([a, b, c, c[::-1].copy()]), a.copy().reshape(1, n)]
