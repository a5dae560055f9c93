"""The node API carried into the port (olavm_tpu_torch/node/olavm.py,
state/{node_state, store}.py) against olavm_tpu's node on the sccall
fixture pair (tests/fixtures/sccall_caller_asm.json and
sccall_callee_asm.json, deployed and run by chip_smoke.node_tx): the caller's
tx records an sccall row and two envs, and both nodes give the same merged
tx trace, the same 12 tables, the same account-tree root and public values,
and cross-table lookups that balance. The node golden
(tests/fixtures/node_sccall_golden.json, olavm_tpu's host prover) describes
this same tx. Exact comparisons throughout; seconds on the CPU."""

import dataclasses
import json
import os

import numpy as np
import pytest

from chip_smoke import NODE_CALLEE, NODE_CALLER, node_tx
import torch_threads  # noqa: F401  (torch's share of the cores)

FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fixtures")
PACKAGES = ("olavm_tpu", "olavm_tpu_torch")


@pytest.fixture(scope="module")
def nodes():
    from olavm_tpu.runtime import trace_io as j_io
    from olavm_tpu_torch.runtime import trace_io as t_io

    out = {}
    for package, io in zip(PACKAGES, (j_io, t_io)):
        node, trace, traces, pv, ola = node_tx(package)
        out[package] = {"node": node, "trace": trace,
                        "trace_json": io.trace_to_json(trace),
                        "traces": traces, "public_values": pv, "ola": ola}
    return out


def test_port_node_records_an_sccall_and_two_envs(nodes):
    trace = nodes["olavm_tpu_torch"]["trace"]
    assert len(trace.sc_call) == 1
    assert len({s.env_idx for s in trace.exec}) >= 2


def test_tx_trace_matches_reference(nodes):
    assert (nodes["olavm_tpu_torch"]["trace_json"]
            == nodes["olavm_tpu"]["trace_json"])


def test_tables_match_reference(nodes):
    got, want = nodes["olavm_tpu_torch"]["traces"], nodes["olavm_tpu"]["traces"]
    assert len(got) == len(want) == 12
    for t, w in zip(got, want):
        np.testing.assert_array_equal(t, w)


def test_account_root_and_public_values_match_reference(nodes):
    got, want = nodes["olavm_tpu_torch"], nodes["olavm_tpu"]
    assert (got["node"].account_tree.root_hash()
            == want["node"].account_tree.root_hash())
    assert (dataclasses.astuple(got["public_values"])
            == dataclasses.astuple(want["public_values"]))
    # both contracts are in the tree: the root moved from the empty tree's
    from olavm_tpu_torch.tree.smt import AccountTree

    assert got["node"].account_tree.root_hash() != AccountTree().root_hash()


def test_cross_table_lookups_balance(nodes):
    from olavm_tpu_torch.stark.challenger import Challenger
    from olavm_tpu_torch.stark.config import StarkConfig
    from olavm_tpu_torch.stark.cross_table_lookup import (
        cross_table_lookup_data,
        verify_cross_table_lookups,
    )

    port = nodes["olavm_tpu_torch"]
    ctls = port["ola"].cross_table_lookups
    config = StarkConfig.standard_fast_config()
    challenger = Challenger()
    challenger.observe_element(7)
    data = cross_table_lookup_data(config, port["traces"], ctls, challenger)
    verify_cross_table_lookups(
        ctls, [[int(zc.z[-1]) for zc in d.zs_columns] for d in data], config)


def test_node_golden_describes_this_tx(nodes):
    with open(os.path.join(FIXTURES, "node_sccall_golden.json")) as f:
        golden = json.load(f)
    port = nodes["olavm_tpu_torch"]
    pv = port["public_values"]
    assert golden["contracts"] == [{"program": name, "address": list(addr)}
                                   for name, addr in (NODE_CALLER, NODE_CALLEE)]
    assert golden["steps"] == len(port["trace"].exec)
    assert golden["sccall_rows"] == len(port["trace"].sc_call)
    assert golden["table_shapes"] == [list(t.shape) for t in port["traces"]]
    assert golden["public_values"] == {
        "pre_root": list(pv.pre_state_root), "post_root": list(pv.post_state_root)}


def test_port_deploy_persists_across_instances(tmp_path):
    from olavm_tpu_torch.assembler.encoder import encode_asm_from_json_file
    from olavm_tpu_torch.node.olavm import OlaVM

    tree_db, state_db = str(tmp_path / "tree.db"), str(tmp_path / "state.db")
    node = OlaVM(tree_db, state_db)
    code_hash = node.manual_deploy(encode_asm_from_json_file(
        os.path.join(FIXTURES, NODE_CALLEE[0])), (2, 2, 2, 2))
    node2 = OlaVM(tree_db, state_db)
    assert node2.ola_state.get_contract_map((2, 2, 2, 2)) == code_hash
    node2.execute_tx((2, 2, 2, 2), (2, 2, 2, 2), [])
    trace = node2.ola_state.gen_tx_trace()
    assert trace.exec and not trace.sc_call
