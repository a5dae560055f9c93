"""The port's execute and trace generation (olavm_tpu_torch.runtime.harness,
tables/fast_gen.py) on the fib-loop fixture at N=10 against olavm_tpu's:
every one of the 12 tables and the state roots must be equal."""

import tempfile

import numpy as np

from olavm_tpu.runtime.harness import run_program_fast
from olavm_tpu.tables.fast_gen import generate_traces_fast
from olavm_tpu.tables.ola_stark import OlaStark
from olavm_tpu_torch.runtime import harness as tharness
from olavm_tpu_torch.tables import fast_gen as tfast_gen
from olavm_tpu_torch.tables import ola_stark as tola_stark

from chip_smoke import write_fib_program
import torch_threads  # noqa: F401  (torch's share of the cores)


def test_fixture_traces_equal_reference():
    with tempfile.TemporaryDirectory() as d:
        path = write_fib_program(10, d)
        run, process, program, _ = run_program_fast(path, calldata=None)
        want = generate_traces_fast(run, program, OlaStark(), process)
        trun, tprocess, tprogram, _ = tharness.run_program_fast(path,
                                                                calldata=None)
        got = tfast_gen.generate_traces_fast(trun, tprogram,
                                             tola_stark.OlaStark(), tprocess)
    assert trun.cpu.shape == run.cpu.shape
    assert len(got) == len(want) == 12
    assert [list(t.shape) for t in got][:2] == [[94, 128], [29, 32]]
    for i, (a, b) in enumerate(zip(got, want)):
        assert a.dtype == b.dtype == np.uint64, i
        np.testing.assert_array_equal(a, b, err_msg=f"table {i}")
    assert tprogram.trace.start_end_roots == program.trace.start_end_roots
