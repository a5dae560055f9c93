"""The port stands on its own: every olavm_tpu_torch module imports with jax,
jaxlib AND the olavm_tpu package refused, and the main path (the fib-loop
fixture's execute and trace generation, then a ToySystem-sized prove and
verify on the CPU path, and the same prove sharded over a one-rank group)
runs in that state or, where both are installed,
without loading either; so does the interpreter path (run_program_full and
generate_traces on the instruction-set fixture). No source of the port imports jax or olavm_tpu or
reads a file out of olavm_tpu/, and importing the port leaves the reference
package's host libraries as they are.

Each subprocess case runs in a fresh interpreter, since this test process
has jax."""

import json
import os
import re
import subprocess
import sys
import textwrap

import pytest
import torch_threads

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

REFUSE_JAX_AND_REFERENCE = """
import sys
class Refuse:
    @staticmethod
    def find_spec(name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "olavm_tpu"):
            raise ImportError("refused: " + name)
        return None
sys.meta_path.insert(0, Refuse)
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
result["entry_points"] = sorted(set(names) & {
    "olavm_tpu_torch.cli.main", "olavm_tpu_torch.runtime.trace_io",
    "olavm_tpu_torch.stark.oracle", "olavm_tpu_torch.stark.prover",
    "olavm_tpu_torch.utils.trace_analyzer", "olavm_tpu_torch.node.olavm",
    "olavm_tpu_torch.state.node_state", "olavm_tpu_torch.state.store",
    "olavm_tpu_torch.parallel", "olavm_tpu_torch.parallel.sharded",
    "olavm_tpu_torch.utils.jitcache", "olavm_tpu_torch.stark.constraint_tape",
    "olavm_tpu_torch.stark.constraint_codegen"})
"""

REFERENCE_NATIVE = """
# the port imported first must leave the reference package's host libraries
# (and the import machinery) as they were
meta_path = list(sys.meta_path)
import olavm_tpu_torch
from olavm_tpu_torch.native import lookup_native, ntt_native
result["meta_path_untouched"] = list(sys.meta_path) == meta_path
result["port_native"] = [olavm_tpu_torch.native.available,
                         ntt_native.available, lookup_native.available]
import olavm_tpu.native as ref_native
from olavm_tpu.native import lookup_native as ref_lookup, ntt_native as ref_ntt
result["native"] = [ref_native.available, ref_ntt.available,
                    ref_lookup.available]
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

NODE_TX = """
from chip_smoke import node_tx
node, trace, traces, pv, ola = node_tx()
result["node"] = [len(trace.sc_call), len(traces)]
"""

ALLOPS_TRACE_GEN = """
# the interpreter path (run_program_full -> generate_traces) on the
# instruction-set fixture
from chip_smoke import ALLOPS_K, allops_traces
traces, pv, ola, program_sha256 = allops_traces(ALLOPS_K)
result["allops_shapes"] = [list(t.shape) for t in traces]
"""

TOY_PROVE = """
import numpy as np
from olavm_tpu_torch.field import goldilocks as g
from olavm_tpu_torch.stark.cross_table_lookup import (
    Column, CrossTableLookup, TableWithColumns)
from olavm_tpu_torch.stark.stark_base import PermutationPair, Stark
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
# the programs' eager path (programs=False) gives the same proof
from olavm_tpu_torch.stark.serialization import serialize_all_proof as ser
eager = prove_with_traces_device(
    Toy(), config, [np.stack([a, b, c, c[::-1].copy()]), a.reshape(1, n)],
    device="cpu", programs=False)
result["eager_equal"] = ser(eager) == ser(proof)
"""

SHARDED_PROVE = """
# after TOY_PROVE: the sharded prover in a one-rank gloo group on the CPU
import tempfile
import torch.distributed as dist
from olavm_tpu_torch.parallel.sharded import prove_with_traces_sharded
from olavm_tpu_torch.stark.config import MeshConfig
from olavm_tpu_torch.stark.serialization import serialize_all_proof

with tempfile.TemporaryDirectory() as d:
    dist.init_process_group("gloo", init_method="file://" + d + "/rdv",
                            world_size=1, rank=0)
    config.mesh = MeshConfig(device_type="cpu")
    sharded = prove_with_traces_sharded(
        Toy(), config, [np.stack([a, b, c, c[::-1].copy()]), a.reshape(1, n)],
        device="cpu")
    dist.destroy_process_group()
result["sharded_equal"] = serialize_all_proof(sharded) == serialize_all_proof(proof)
"""


def _run(*parts: str) -> dict:
    """Run the parts in a fresh interpreter; returns their `result` dict and
    the jax and olavm_tpu modules loaded by the end."""
    head = (f"import json, os, sys\nsys.path.insert(0, {ROOT!r})\n"
            "result = {}\n")
    tail = ("result['jax_loaded'] = sorted(m for m in sys.modules\n"
            "    if m.split('.')[0] in ('jax', 'jaxlib'))\n"
            "result['reference_loaded'] = sorted(m for m in sys.modules\n"
            "    if m.split('.')[0] == 'olavm_tpu')\n"
            "print(json.dumps(result))\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["OMP_NUM_THREADS"] = str(torch_threads.THREADS)
    code = head + "".join(textwrap.dedent(p) for p in parts) + tail
    out = subprocess.run([sys.executable, "-c", code],
                         capture_output=True, text=True, timeout=240, cwd=ROOT,
                         env=env)
    assert out.returncode == 0, out.stderr[-4000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_port_imports_and_runs_with_jax_refused():
    res = _run(REFUSE_JAX_AND_REFERENCE, IMPORT_ALL, TRACE_GEN, NODE_TX,
               TOY_PROVE, SHARDED_PROVE)
    assert res["modules"] >= 84
    # the host prover, the CLI's, the node's, the sharded prover's, the
    # program layer's and K6's modules, among them
    assert len(res["entry_points"]) == 13
    assert len(res["shapes"]) == 12 and res["shapes"][0] == [94, 128]
    assert res["node"] == [1, 12]
    assert res["verified"] and res["sharded_equal"] and res["eager_equal"]
    assert res["jax_loaded"] == [] and res["reference_loaded"] == []


def test_interpreter_path_runs_with_jax_refused():
    res = _run(REFUSE_JAX_AND_REFERENCE, ALLOPS_TRACE_GEN)
    assert len(res["allops_shapes"]) == 12
    assert res["allops_shapes"][5] == [134, 1 << 13]  # PoseidonStark
    assert res["jax_loaded"] == [] and res["reference_loaded"] == []


def test_port_leaves_installed_jax_unloaded():
    # where jax and olavm_tpu are installed, the port must still load neither
    pytest.importorskip("jax")
    res = _run("import olavm_tpu_torch\n", TOY_PROVE)
    assert res["verified"]
    assert res["jax_loaded"] == [] and res["reference_loaded"] == []


def test_port_import_leaves_reference_native_alone():
    # the port once imported olavm_tpu.native with jax refused, which left
    # that package's Poseidon library off for the process
    pytest.importorskip("jax")
    res = _run(REFERENCE_NATIVE)
    assert res["meta_path_untouched"]
    assert res["port_native"] == [True, True, True]
    assert res["native"] == [True, True, True]


def _port_sources():
    paths = [os.path.join(ROOT, name) for name in
             ("chip_smoke.py", "chip_profile.py", "chip_kernel_times.py")]
    for base, _, files in os.walk(os.path.join(ROOT, "olavm_tpu_torch")):
        paths += [os.path.join(base, f) for f in files if f.endswith(".py")]
    return paths


IMPORT_OF = {
    "jax": re.compile(r"^\s*(from|import)\s+jax(lib)?(\.|\s|$)"),
    "olavm_tpu": re.compile(r"^\s*(from|import)\s+olavm_tpu(\.|\s|$)"),
}


def test_no_port_source_imports_jax():
    for path in _port_sources():
        with open(path) as f:
            for line in f:
                assert not IMPORT_OF["jax"].match(line), (path, line)


def test_no_port_source_imports_reference():
    assert len(_port_sources()) >= 65
    for path in _port_sources():
        with open(path) as f:
            for line in f:
                assert not IMPORT_OF["olavm_tpu"].match(line), (path, line)


def test_no_port_source_reads_reference_files():
    # a path into the reference package would be spelled with its directory
    # name as a string of its own
    literal = re.compile(r"""["']olavm_tpu["'/.]""")
    for path in _port_sources():
        if path.endswith("chip_smoke.py"):
            continue  # names the TPU kernels it replaces, as "olavm_tpu/...:line"
        with open(path) as f:
            for line in f:
                assert not literal.search(line), (path, line)


def test_port_init_does_not_touch_the_import_machinery():
    with open(os.path.join(ROOT, "olavm_tpu_torch", "__init__.py")) as f:
        text = f.read()
    assert "meta_path" not in text and "import " not in text
