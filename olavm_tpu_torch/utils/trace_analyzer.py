"""Carried from olavm_tpu/utils/trace_analyzer.py: the port imports nothing of olavm_tpu, so it
keeps its own copy; the code is unchanged.

Trace inspection tooling — replaces the reference's Excel exporter
(infrastructure/trace_analyzer/generate_table.py) with pandas DataFrames /
parquet-or-csv dumps, one table per sub-trace.

Usage:
    python -m olavm_tpu_torch.utils.trace_analyzer trace.json out_dir [--fmt csv]
"""

from __future__ import annotations

import argparse
import dataclasses
import os


_TABLES = [
    "exec", "memory", "builtin_rangecheck", "builtin_bitwise_combined",
    "builtin_cmp", "builtin_poseidon", "builtin_poseidon_chunk",
    "builtin_storage", "builtin_storage_hash", "builtin_program_hash",
    "tape", "sc_call",
]


def _flatten(row) -> dict:
    out = {}
    for f in dataclasses.fields(row):
        v = getattr(row, f.name)
        if dataclasses.is_dataclass(v):
            for k, sub in _flatten(v).items():
                out[f"{f.name}.{k}"] = sub
        elif isinstance(v, (list, tuple)):
            for i, x in enumerate(v):
                if isinstance(x, (list, tuple)):
                    for j, y in enumerate(x):
                        out[f"{f.name}[{i}][{j}]"] = int(y)
                else:
                    out[f"{f.name}[{i}]"] = int(x)
        elif isinstance(v, bool):
            out[f.name] = int(v)
        else:
            out[f.name] = int(v)
    return out


def trace_to_frames(trace) -> dict:
    """Trace -> {table_name: pandas.DataFrame} (hex view via .map(hex))."""
    import pandas as pd

    frames = {}
    for name in _TABLES:
        rows = getattr(trace, name)
        frames[name] = pd.DataFrame([_flatten(r) for r in rows])
    return frames


def dump_trace(trace, out_dir: str, fmt: str = "parquet") -> list[str]:
    os.makedirs(out_dir, exist_ok=True)
    written = []
    for name, df in trace_to_frames(trace).items():
        path = os.path.join(out_dir, f"{name}.{'csv' if fmt == 'csv' else 'parquet'}")
        if fmt == "csv":
            df.to_csv(path, index=False)
        else:
            try:
                df.to_parquet(path)
            except Exception:  # no parquet engine -> csv fallback
                path = os.path.join(out_dir, f"{name}.csv")
                df.to_csv(path, index=False)
        written.append(path)
    return written


def main(argv=None):
    from ..runtime.trace_io import trace_from_json

    ap = argparse.ArgumentParser(description="dump an execution trace to tables")
    ap.add_argument("trace_json")
    ap.add_argument("out_dir")
    ap.add_argument("--fmt", choices=["parquet", "csv"], default="parquet")
    args = ap.parse_args(argv)
    with open(args.trace_json) as f:
        trace = trace_from_json(f.read())
    for path in dump_trace(trace, args.out_dir, args.fmt):
        print(path)


if __name__ == "__main__":
    main()
