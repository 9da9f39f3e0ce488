#!/usr/bin/env python3
"""Runs one cell of the benchmark of `rlobjectdetection_tpu_torch` once.

    python3 port_bench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

The cell names a configuration (`port_bench/configs/<name>.json`) and a
traffic mix (`port_bench/traffic/<name>.json`), whose `driver` names the
loop in `port_bench/drivers/`; each per-layer metric is read by
`port_bench/metrics/<metric>.py`. All are found by the names that
`BENCHMARK.json` gives, so a cell or a metric is added by adding files.

Prints as its last line on standard output one JSON object: `correct`,
`attempted`, `failed`, `metrics` (the cell's end-to-end metrics, or with
`--trace 1` its per-layer ones), `device`, with `--trace 1` `breakdown`,
and last `compared` (each number held against its limit), which the last
lines on standard error repeat. `--control 1` runs the reference in the
program's place one precision below the configuration's (fp8 for bf16,
TF32 for float32), `--control 2` (training cells) the reference on half of
each batch, the mean taken over the rest; both print only `correct` and
`compared`.

Exits non-zero, printing no result, without a CUDA device (there is no CPU
fallback), outside a checkout that holds the port, or when `jax`, `jaxlib`,
`flax` or `rlobjectdetection_tpu` is loaded once the window has closed.
"""

from __future__ import annotations

import os
import sys
import time

T0 = time.perf_counter()
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HERE = os.path.join(ROOT, "port_bench")
# the script's own folder is no place to import from (its trace.py would
# shadow the standard library's); the harness is the package port_bench
sys.path[:] = [p for p in sys.path if os.path.abspath(p or ".") != HERE]

import argparse  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import shutil  # noqa: E402
import tempfile  # noqa: E402
FORBIDDEN = ("jax", "jaxlib", "flax", "rlobjectdetection_tpu")


def parse(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", required=True, type=int)
    p.add_argument("--seconds", required=True, type=float)
    p.add_argument("--trace", type=int, default=0, choices=(0, 1))
    p.add_argument("--control", type=int, default=0, choices=(0, 1, 2))
    return p.parse_args(argv)


def load_json(*parts) -> dict:
    with open(os.path.join(*parts)) as f:
        return json.load(f)


def cell(bench: dict, name: str) -> tuple[dict, dict, dict]:
    """(workload, configuration, traffic) of the cell `name`."""
    work = {w["name"]: w for w in bench["workloads"]}[name]
    entry = {c["name"]: c for c in bench["configs"]}[work["config"]]
    return work, load_json(ROOT, entry["file"]), load_json(HERE, "traffic",
                                                           work["traffic"] + ".json")


def reported(bench: dict, name: str, trace: bool) -> list:
    """The metrics the cell reports in this kind of run."""
    e2e = [m for m in bench["end_to_end"] if name in m.get("workloads", [name])]
    if not trace:
        return e2e
    moved = {m["name"] for m in e2e}
    return [m for m in bench["per_layer"]
            if name in m.get("workloads", [name] if m["moves"] in moved else [])]


def reader(metric: str):
    """`port_bench/metrics/<metric>.py`'s `read(span, run)`."""
    spec = importlib.util.spec_from_file_location(
        "port_bench_metric_" + metric.replace(".", "_").replace("-", "_"),
        os.path.join(HERE, "metrics", metric + ".py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def loaded_forbidden() -> list:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def main(argv=None, device: str = "cuda") -> int:
    args = parse(argv)
    bench = load_json(ROOT, "BENCHMARK.json")
    work, config, traffic = cell(bench, args.workload)
    # caches of the program's compilers at fixed paths inside the checkout
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", os.path.join(ROOT, ".cache", "torch_extensions"))
    os.environ.setdefault("TRITON_CACHE_DIR", os.path.join(ROOT, ".cache", "triton"))
    os.environ["USE_FLAX"] = "0"
    sys.path.insert(0, ROOT)
    import torch

    if device == "cuda" and (not torch.cuda.is_available()
                             or torch.cuda.device_count() < work["chips"]):
        print(f"port_bench: the cell needs {work['chips']} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}: no result "
              f"(this benchmark does not fall back to the CPU)", file=sys.stderr)
        return 2
    try:
        import rlobjectdetection_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"port_bench: the program is not in this checkout ({e}): no result",
              file=sys.stderr)
        return 2
    from port_bench import harness

    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    workdir = tempfile.mkdtemp(prefix="port_bench_")
    try:
        run = harness.Run(workload=args.workload, seed=args.seed, seconds=args.seconds,
                          trace=bool(args.trace), config=config, traffic=traffic, t0=T0,
                          device=device, workdir=workdir, control=args.control)
        driver = importlib.import_module(f"port_bench.drivers.{traffic['driver']}")
        result = driver.run(run)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    bad = loaded_forbidden()
    if bad:
        print(f"port_bench: modules {bad} are loaded in the measuring process: no result",
              file=sys.stderr)
        return 3
    line = emit(bench, run, result)
    for name, v in line["compared"].items():
        print(f"compared {name}: {v['value']!r} (limit {v['limit']!r})", file=sys.stderr)
    print(json.dumps(line), flush=True)
    return 0


def emit(bench: dict, run, result: dict) -> dict:
    """The result line of the run."""
    from port_bench import harness

    if run.control:
        return {"correct": result["correct"], "compared": result["compared"]}
    metrics = {}
    span = result["span"]
    for m in reported(bench, run.workload, run.trace):
        if run.trace:
            value = reader(m["name"])(span, run)
        elif m["name"] == "setup_s":
            value = result["setup_s"]
        else:
            value = result["metrics"][m["name"]]["value"]
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    line = {"correct": bool(result["correct"]), "attempted": result["attempted"],
            "failed": result["failed"], "metrics": metrics,
            "device": harness.device_info(run.device, result["peak"])}
    trace = span.get("trace")
    if run.trace:
        from port_bench import counts

        if trace is None:
            raise RuntimeError("the traced run's profiler window did not close in the window")
        line["device"].update(busy_s=trace.busy_s(), window_s=trace.window_s)
        line["breakdown"] = trace.breakdown(counts.kernel_op)
        line["device"]["power_limit"] = counts.power_limit()
    line["compared"] = result["compared"]
    return line


if __name__ == "__main__":
    sys.exit(main())
