"""PyTorch and CUDA port of the olavm_tpu STARK prover.

The port imports torch and never jax. It reuses the modules of olavm_tpu
that load without jax (the field's host ops, the assembler, interpreter and
most tables) and carries jax-free copies of the host modules that do not.

One reused package needs care: olavm_tpu/native/__init__.py builds the host
Poseidon library and reads its constants through olavm_tpu.hash.poseidon,
which imports jax. The port uses only that package's jax-free submodules
(ntt_native through field/goldilocks.py, lookup_native through
stark/lookup.py); its own Poseidon binding is native/. So where jax is not
loaded yet, the package is imported here once with jax imports refused: its
init then falls back as it was written to (`available = False`), and jax
stays out of the process even on a machine where it is installed.

This has a side effect on the reference package: for the rest of the process
olavm_tpu.native.available stays False, so olavm_tpu's host code, where it
runs in the same process after this import, takes its numpy Poseidon path
instead of the native library. Its other native submodules (ntt_native,
lookup_native) still load. Importing jax before this
package leaves olavm_tpu.native to load normally.
"""

import importlib
import sys
import warnings


class _RefuseJax:
    """Meta-path finder that refuses jax and jaxlib imports."""

    @staticmethod
    def find_spec(name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib"):
            raise ImportError(f"olavm_tpu_torch does not load {name}")
        return None


def _import_reference_native() -> None:
    if "olavm_tpu.native" in sys.modules or "jax" in sys.modules:
        return
    sys.meta_path.insert(0, _RefuseJax)
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            importlib.import_module("olavm_tpu.native")
    finally:
        sys.meta_path.remove(_RefuseJax)


_import_reference_native()
