"""Carried from olavm_tpu/runtime/load_tx.py: the port imports nothing of olavm_tpu, so it
keeps its own copy; the code is unchanged.

Tape initialization: tx context + calldata + addresses
(executor/src/load_tx.rs:89-138)."""

from __future__ import annotations

from dataclasses import dataclass, field as dfield


@dataclass
class TxCtxInfo:
    block_number: int = 0
    block_timestamp: int = 0
    sequencer_address: tuple = (0, 0, 0, 0)
    version: int = 0
    chain_id: int = 0
    caller_address: tuple = (0, 0, 0, 0)
    nonce: int = 0
    signature_r: tuple = (0, 0, 0, 0)
    signature_s: tuple = (0, 0, 0, 0)
    tx_hash: tuple = (0, 0, 0, 0)


def mock_tx_ctx() -> TxCtxInfo:
    """init_tx_context_mock (core/src/vm/transaction.rs:20-60)."""
    return TxCtxInfo(
        block_number=3,
        block_timestamp=1692846754,
        sequencer_address=(1, 2, 3, 4),
        version=3,
        chain_id=1,
        caller_address=(5, 6, 7, 8),
        nonce=25,
        signature_r=(129, 130, 131, 132),
        signature_s=(133, 134, 135, 136),
        tx_hash=(137, 138, 139, 140),
    )


def _load_fe(process, value: int):
    process.tape.write(process.tp, 0, 0, 1, 0, value)
    process.tp += 1


def _load_fields(process, values):
    for v in values:
        _load_fe(process, v)


def init_tape(process, calldata, caller_exe_addr, callee_addr, callee_exe_addr,
              ctx: TxCtxInfo):
    _load_fe(process, ctx.block_number)
    _load_fe(process, ctx.block_timestamp)
    _load_fields(process, ctx.sequencer_address)
    _load_fe(process, ctx.version)
    _load_fe(process, ctx.chain_id)
    _load_fields(process, ctx.caller_address)
    _load_fe(process, ctx.nonce)
    _load_fields(process, ctx.signature_r)
    _load_fields(process, ctx.signature_s)
    _load_fields(process, ctx.tx_hash)
    _load_fields(process, calldata)
    _load_fields(process, caller_exe_addr)
    _load_fields(process, callee_addr)
    _load_fields(process, callee_exe_addr)


def append_caller_callee_addr(process, caller_exe_addr, callee_code_addr,
                              callee_exe_addr):
    """12 address words appended at an sccall (load_tx.rs:138-148). Written
    with the SCCALL opcode and filter_looked=1 so the cpu->tape CTL rows
    emitted by the sccall ext line balance (see ola_stark ctl_cpu_tape)."""
    from ..isa.opcodes import Opcode

    op = 1 << Opcode.SCCALL.shift
    for v in list(caller_exe_addr) + list(callee_code_addr) + list(callee_exe_addr):
        process.tape.write(process.tp, 0, op, 0, 1, int(v))
        process.tp += 1
