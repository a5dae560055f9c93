"""Carried from olavm_tpu/stark/challenger.py: the card has no jax, so this copy imports
only jax-free modules; its code is unchanged.

Fiat-Shamir challenger: Poseidon duplex sponge in overwrite mode.

Bit-exact re-implementation of the reference transcript
(plonky2/plonky2/src/iop/challenger.rs:18-161): rate-8 absorb buffer,
duplexing on full buffer or on demand, challenges popped from the END of the
output buffer, `compact()` returning the full sponge state.
"""

from __future__ import annotations

import numpy as np

from ..field import goldilocks as g
from ..hash import poseidon as pos

RATE = 8
WIDTH = 12


class Challenger:
    def __init__(self):
        self.sponge_state = [0] * WIDTH
        self.input_buffer: list[int] = []
        self.output_buffer: list[int] = []

    def observe_element(self, element: int):
        self.output_buffer.clear()
        self.input_buffer.append(int(element))
        if len(self.input_buffer) == RATE:
            self._duplexing()

    def observe_elements(self, elements):
        for e in elements:
            self.observe_element(e)

    def observe_array(self, arr):
        """Bulk absorb of a uint64 array (native fast path; equivalent to
        observe_element per value)."""
        arr = np.asarray(arr, dtype=np.uint64).reshape(-1)
        from ..hash.poseidon import _native

        native = _native()
        if native is None or arr.size < 64:
            self.observe_elements(int(v) for v in arr)
            return
        self.output_buffer.clear()
        pending = np.array(self.input_buffer, dtype=np.uint64)
        allv = np.concatenate([pending, arr]) if pending.size else arr
        nfull = (allv.size // RATE) * RATE
        state = np.array(self.sponge_state, dtype=np.uint64)
        if nfull:
            # full blocks only: the tail stays in input_buffer and must NOT
            # touch the state (matches observe_element/_duplexing exactly)
            left = native.absorb_stream(state, 0, allv[:nfull])
            assert left == 0
            self.sponge_state = [int(v) for v in state]
            self.output_buffer = list(self.sponge_state[:RATE])
        self.input_buffer = [int(v) for v in allv[nfull:]]
        if self.input_buffer:
            self.output_buffer = []

    def observe_extension_element(self, e):
        self.observe_element(int(np.asarray(e)[..., 0]))
        self.observe_element(int(np.asarray(e)[..., 1]))

    def observe_extension_elements(self, elements):
        for e in elements:
            self.observe_extension_element(e)

    def observe_hash(self, hash4, hasher=None):
        """Absorb a digest; for byte hashers this is BytesHash::to_vec
        (7-byte chunks -> 5 elements), for Poseidon the 4 elements."""
        if hasher is None:
            self.observe_elements(int(x) for x in hash4)
        else:
            self.observe_elements(hasher.digest_to_fields(hash4))

    def observe_cap(self, cap, hasher=None):
        """cap: (n, 4) array or list of 4-element digests."""
        for digest in cap:
            self.observe_hash(digest, hasher)

    def get_challenge(self) -> int:
        if self.input_buffer or not self.output_buffer:
            self._duplexing()
        return self.output_buffer.pop()

    def get_n_challenges(self, n: int) -> list[int]:
        return [self.get_challenge() for _ in range(n)]

    def get_hash(self) -> list[int]:
        return self.get_n_challenges(4)

    def get_extension_challenge(self) -> np.ndarray:
        a = self.get_challenge()
        b = self.get_challenge()
        return np.array([a, b], dtype=np.uint64)

    def compact(self) -> list[int]:
        if self.input_buffer:
            self._duplexing()
        self.output_buffer.clear()
        return list(self.sponge_state)

    def _duplexing(self):
        assert len(self.input_buffer) <= RATE
        for i, v in enumerate(self.input_buffer):
            self.sponge_state[i] = v
        self.input_buffer.clear()
        out = pos.permute_np(np.array(self.sponge_state, dtype=np.uint64))
        self.sponge_state = [int(x) for x in out]
        self.output_buffer = list(self.sponge_state[:RATE])
