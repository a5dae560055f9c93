"""The port runs without jax: every olavm_tpu_torch module imports with jax
refused, and the main path (the fib-loop fixture's execute and trace
generation, then a ToySystem-sized prove and verify on the CPU path) runs
either with jax refused or, where jax is installed, without loading it.

Each case runs in a fresh interpreter, since this test process has jax."""

import json
import os
import subprocess
import sys
import textwrap

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

REFUSE_JAX = """
import sys
class RefuseJax:
    @staticmethod
    def find_spec(name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib"):
            raise ImportError("jax refused: " + name)
        return None
sys.meta_path.insert(0, RefuseJax)
"""

IMPORT_ALL = """
import importlib, importlib.util, pkgutil
import olavm_tpu_torch
names = [m.name for m in pkgutil.walk_packages(olavm_tpu_torch.__path__,
                                               "olavm_tpu_torch.")
         if importlib.util.find_spec(m.name).origin.endswith(".py")]
for name in names:
    importlib.import_module(name)
result["modules"] = len(names)
"""

REFERENCE_NATIVE = """
# importing the port before jax leaves olavm_tpu's native Poseidon off for
# the process; its other native libraries must still load
import olavm_tpu.native as ref_native
from olavm_tpu.native import lookup_native, ntt_native
result["native"] = [ref_native.available, ntt_native.available,
                    lookup_native.available]
"""

TRACE_GEN = """
import tempfile
from chip_smoke import write_fib_program
from olavm_tpu_torch.runtime.harness import run_program_fast
from olavm_tpu_torch.tables.fast_gen import generate_traces_fast
from olavm_tpu_torch.tables.ola_stark import OlaStark

with tempfile.TemporaryDirectory() as d:
    fast_run, process, program, _ = run_program_fast(
        write_fib_program(10, d), calldata=None)
traces = generate_traces_fast(fast_run, program, OlaStark(), process)
result["shapes"] = [list(t.shape) for t in traces]
"""

TOY_PROVE = """
import numpy as np
from olavm_tpu.field import goldilocks as g
from olavm_tpu.stark.cross_table_lookup import (
    Column, CrossTableLookup, TableWithColumns)
from olavm_tpu.stark.stark_base import PermutationPair, Stark
from olavm_tpu_torch.stark.config import FriConfig, StarkConfig
from olavm_tpu_torch.stark.prover_device import prove_with_traces_device
from olavm_tpu_torch.stark.verifier import verify_proof


class FibStark(Stark):
    COLUMNS = 4

    def eval_packed(self, local, nxt, consumer):
        F = consumer.F
        consumer.constraint_first_row(F.sub(local[0], F.constant(1)))
        consumer.constraint_transition(F.sub(nxt[0], local[1]))
        consumer.constraint_transition(F.sub(nxt[1], F.add(local[0], local[1])))

    def constraint_degree(self):
        return 3

    def permutation_pairs(self):
        return [PermutationPair.singletons(2, 3)]


class CopyStark(Stark):
    COLUMNS = 1

    def eval_packed(self, local, nxt, consumer):
        pass

    def constraint_degree(self):
        return 3


class Toy:
    starks = [FibStark(), CopyStark()]
    cross_table_lookups = [CrossTableLookup(
        looking_tables=[TableWithColumns(0, [Column.single(0)], None)],
        looked_table=TableWithColumns(1, [Column.single(0)], None))]

    def compress_challenges(self):
        return [0, 0]


n = 32
a, b = np.zeros(n, np.uint64), np.zeros(n, np.uint64)
a[0] = b[0] = 1
for i in range(1, n):
    a[i], b[i] = b[i - 1], g.add(int(a[i - 1]), int(b[i - 1]))
c = np.random.default_rng(0).integers(0, 1 << 32, n, dtype=np.uint64)
config = StarkConfig(fri_config=FriConfig(proof_of_work_bits=8))
proof = prove_with_traces_device(
    Toy(), config, [np.stack([a, b, c, c[::-1].copy()]), a.reshape(1, n)],
    device="cpu")
verify_proof(Toy(), proof, config)
result["verified"] = True
"""


def _run(*parts: str) -> dict:
    """Run the parts in a fresh interpreter; returns their `result` dict and
    the jax modules loaded by the end."""
    head = (f"import json, os, sys\nsys.path.insert(0, {ROOT!r})\n"
            "result = {}\n")
    tail = ("result['jax_loaded'] = sorted(m for m in sys.modules\n"
            "    if m.split('.')[0] in ('jax', 'jaxlib'))\n"
            "print(json.dumps(result))\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    code = head + "".join(textwrap.dedent(p) for p in parts) + tail
    out = subprocess.run([sys.executable, "-c", code],
                         capture_output=True, text=True, timeout=240, cwd=ROOT,
                         env=env)
    assert out.returncode == 0, out.stderr[-4000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_port_imports_and_runs_with_jax_refused():
    res = _run(REFUSE_JAX, IMPORT_ALL, REFERENCE_NATIVE, TRACE_GEN, TOY_PROVE)
    assert res["modules"] >= 30
    assert res["native"] == [False, True, True]
    assert len(res["shapes"]) == 12 and res["shapes"][0] == [94, 128]
    assert res["verified"] and res["jax_loaded"] == []


def test_port_leaves_installed_jax_unloaded():
    # where jax is installed, the port must still not load it
    pytest.importorskip("jax")
    res = _run("import olavm_tpu_torch\n", REFERENCE_NATIVE, TOY_PROVE)
    assert res["native"] == [False, True, True]
    assert res["verified"] and res["jax_loaded"] == []


def test_no_port_source_imports_jax():
    for base, _, files in os.walk(os.path.join(ROOT, "olavm_tpu_torch")):
        for name in files:
            if name.endswith(".py"):
                with open(os.path.join(base, name)) as f:
                    for line in f:
                        assert not line.strip().startswith(
                            ("import jax", "from jax")), (name, line)
