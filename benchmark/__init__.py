"""The benchmark of transplat_tpu_torch (the PyTorch and CUDA port), driven by
BENCHMARK.json at the root of the checkout.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>
    python3 -m pytest benchmark/tests            # CPU
    python3 -m pytest benchmark/tests -m cuda -s [--seeds 1 2 3] [--cells re10k-train]
                                                 # on the card: program and control readings

Layout, all found by name:
  * configs/<config>.json       a model configuration, as it is run
  * traffic/<mix>.json          a traffic mix: parameters of the one
                                generator (harness/traffic.py) and the
                                limits of the comparison with the reference
  * metrics/<metric>.py         one reader a per-layer metric (dots in the
                                name become underscores); the shared
                                arithmetic and the work counts beside them
  * harness/                    the run: set-up, window, trace, comparison
  * harness/kinds/<kind>.py     the driver of a kind of mix (the mix's
                                "kind": "serve", "view", "train"); a new
                                kind, with its own window, is a new file
  * reference/                  the frozen plain float32 reference (a copy of
                                the port's model code with its plain paths, a
                                pixel-by-pixel compositor, clip + Adam); it
                                imports nothing of the program or of JAX

A later cell is an entry in BENCHMARK.json and, where its configuration,
mix or metric is new, a file of its own; no file here needs an edit.
"""
