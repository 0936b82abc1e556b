"""Time K6 of one or more checkouts of the port on the card, in turns.

    python3 spark_rapids_tpu_torch/tools/k6_bench.py [--trees DIR ...]
        [--out DIR]

For each tree given (default: this checkout), in the order given, one
process imports that tree's ``spark_rapids_tpu_torch``, builds its
``csrc/regex_match.cu`` into that tree's ``build/``, and runs its
``kernel_checks.time_k6`` over its ``k6_cases`` other than the edges,
plus the blow-up case (``K6_BLOWUP`` over the LIKE case's text) where
the tree's cases lack it. Every case is first held to the tree's plain
version bit for bit. So ``--trees parent change change parent``, with
the parent unpacked by ``git archive`` into an ignored directory, times
the two kernels on the same inputs and card. Each tree's line is printed
as JSON (case -> ms, plain ms, bytes, the bound at 3.35 TB/s and, where
the tree reports it, the route), and written to ``<out>/k6_bench.json``.
It imports neither jax nor the JAX package.
"""
import argparse
import json
import os
import subprocess
import sys

HBM_BYTES_PER_S = 3.35e12
# kernel_checks.K6_BLOWUP, for trees that predate it
K6_BLOWUP = "a" + "[a-z ]" * 16


def _one(tree: str) -> dict:
    sys.path.insert(0, os.path.abspath(tree))
    import torch

    from spark_rapids_tpu_torch.ops import kernel_checks as kc
    from spark_rapids_tpu_torch.ops import regex
    dev = torch.device("cuda", 0)
    blowup = getattr(kc, "K6_BLOWUP", K6_BLOWUP)
    cases = [c for c in kc.k6_cases(dev) if not c["name"].startswith("edges")]
    if not any(c["pattern"] == blowup for c in cases):
        text = next(c for c in cases if c["name"].startswith("text_like"))
        cases.append(dict(text, name=text["name"].replace("like", "blowup"),
                          pattern=blowup,
                          prog=regex.compile_pattern(blowup)))
    kc.check_k6(dev, cases)
    out = kc.time_k6(dev, cases)
    for t in out.values():
        t["bound_ms"] = t["bytes"] / HBM_BYTES_PER_S * 1e3
    return {"tree": tree, "module": regex.__file__, "cases": out}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--trees", nargs="+", default=["."])
    ap.add_argument("--out", default=None)
    ap.add_argument("--one", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.one is not None:
        print(json.dumps(_one(args.one)), flush=True)
        return
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("k6_bench: no CUDA device")
    results = []
    for tree in args.trees:
        run = subprocess.run([sys.executable, os.path.abspath(__file__),
                              "--one", tree], capture_output=True,
                             text=True, timeout=1200)
        if run.returncode != 0:
            raise SystemExit(f"k6_bench: tree {tree} failed:\n"
                             f"{run.stdout[-4000:]}\n{run.stderr[-4000:]}")
        results.append(json.loads(run.stdout.strip().splitlines()[-1]))
        print(json.dumps(results[-1]), flush=True)
    if args.out:
        os.makedirs(args.out, exist_ok=True)
        with open(os.path.join(args.out, "k6_bench.json"), "w") as f:
            json.dump(results, f, indent=1)


if __name__ == "__main__":
    main()
