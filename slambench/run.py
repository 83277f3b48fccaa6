"""Run one cell of the port's benchmark once and print its result.

    python3 slambench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

The last line of standard output is the result object (``correct``,
``attempted``, ``failed``, ``metrics``, ``device``, with ``--trace 1`` also
``breakdown``, and ``checks`` last: each number compared with its limit);
the line before it is the accuracy (no metric). The checks are also the
last lines of standard error. Exits 2 without a result when there is no
CUDA card or fewer than the cell asks for, and 3 when a module of JAX or
of the JAX package is loaded once the window has closed.

``--control tf32`` puts the reference, computed with TF32 products, in the
program's place: the check's control, never run by the benchmark itself.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BUILD = os.path.join(ROOT, "build")
# every build and kernel cache at a fixed path inside the checkout
os.environ["SINDSLAM_TORCH_BUILD_DIR"] = os.path.join(BUILD,
                                                      "sindslam_tpu_torch")
os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(BUILD, "torch_extensions")
os.environ["TRITON_CACHE_DIR"] = os.path.join(BUILD, "triton")
os.environ["USE_FLAX"] = "0"
# idle OpenMP threads sleep instead of spinning on cores the program's
# launching thread needs
os.environ["OMP_WAIT_POLICY"] = "PASSIVE"
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", choices=("tf32",), default=None)
    args = ap.parse_args(argv)

    import torch

    from slambench.lib import harness

    bench = harness.load_json(ROOT, "BENCHMARK.json")
    chips = next((int(w["chips"]) for w in bench["workloads"]
                  if w["name"] == args.workload), 1)
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"slambench: the cell needs {chips} CUDA card(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}"
              " available", file=sys.stderr)
        return 2
    torch.set_num_threads(4)
    out, accuracy, log = harness.run_cell(args.workload, args.seed, args.seconds,
                                     bool(args.trace), T_START,
                                     control=args.control)
    bad = harness.forbidden_modules()
    if bad:
        print(f"slambench: modules of JAX or the JAX package were loaded: "
              f"{bad}", file=sys.stderr)
        return 3
    print(json.dumps({"accuracy": accuracy}), flush=True)
    print("window calls ms: " + " ".join(
        f"{1e3 * t:.1f}" for t in log["call_s"]), file=sys.stderr)
    print("setup phases s: " + json.dumps(log["setup_s"]), file=sys.stderr)
    for name, c in out["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
