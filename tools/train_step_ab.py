"""``chip_smoke.py`` phase 16 (a)'s MiniCPM-2B training run alone, from the
checkout in the working directory, to compare two checkouts' train steps on
one card in one call.

    cd CHECKOUT && CUBLAS_WORKSPACE_CONFIG=:4096:8 \\
        python3 /path/to/tools/train_step_ab.py

The checkout's own ``chip_smoke.py`` and ``src/`` run (an unpacked older
commit works the same way): ``_train_and_profile`` over ``TRAIN_STEPS``
steps at full width and depth, then one profiled step, under
``torch.use_deterministic_algorithms(True)`` as the smoke's train child
runs it.  Prints one line, ``AB`` and a JSON object: the checkout, each
step's wall in ms (the first one builds the kernels), their median from the
second on, and the profiled step's device ms.  Run the checkouts in turns
(A, B, B, A) in one call: the host's speed moves the walls by up to 1.5x
from one machine to the next, the device time does not.
"""

import json
import os
import sys

sys.path.insert(0, os.getcwd())
sys.path.insert(0, os.path.join(os.getcwd(), "src"))

import torch  # noqa: E402

import chip_smoke as smoke  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.data.pipeline import SyntheticLM  # noqa: E402
from repro_torch.launch.cells import knobs_for  # noqa: E402
from repro_torch.models.config import TRAIN_4K  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402


def main():
    torch.use_deterministic_algorithms(True)
    base = configs.get(smoke.TRAIN_MODEL)
    knobs = knobs_for(base, TRAIN_4K)
    data = SyntheticLM(vocab=base.padded_vocab, seq_len=smoke.TRAIN_SEQ,
                       batch=smoke.TRAIN_ROWS,
                       microbatches=knobs.microbatches, seed=0)
    rec, _, _ = smoke._train_and_profile(
        torch, smoke.TRAIN_MODEL, base, knobs,
        adamw.AdamWConfig(**smoke.TRAIN_OPT), data, 0, smoke.TRAIN_STEPS)
    print("AB " + json.dumps({"tree": os.getcwd(), "step_ms": rec["step_ms"],
                              "median": rec["step_ms_median"],
                              "device_ms": rec["profiled_step"]["device_ms"]}))


if __name__ == "__main__":
    main()
