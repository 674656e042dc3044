"""Two checkouts' ms an iteration on one card, in turns (not a test).

    python3 tests/check_per_iteration_ab.py PARENT CHANGE

Each checkout (a directory holding ``chip_smoke.py`` and the port, e.g. a
``git archive`` unpacked under ``build/``) runs in a process of its own, in
the order parent, change, change, parent, twice: the main path's
AuxLaplaceIVA IP at 2 x 2049 x 469, loss on and off, and GaussILRMA(10) IP,
each by ``chip_smoke.per_iteration``.  One JSON line per run.
"""

import json
import subprocess
import sys

MEASURE = r'''
import functools, json, sys
sys.path.insert(0, sys.argv[1])
import numpy as np, torch
import chip_smoke as cs
from audio_source_separation_tpu_torch import GaussILRMA, stft
torch.backends.cuda.matmul.allow_tf32 = False
cs._build.build_all()
mixture, _ = cs.synth_mixture(np.random.RandomState(cs.SEED), 2, cs.N_SAMPLES)
X = stft(mixture.astype(np.float32), fft_size=cs.FFT_SIZE, hop_size=cs.HOP_SIZE)
out = {"iva_on": cs.per_iteration(X, True), "iva_off": cs.per_iteration(X, False)}
np.random.seed(cs.SEED)
out["ilrma_on"] = cs.per_iteration(X, True, make=functools.partial(GaussILRMA, n_basis=10), n=20, warm=2)
print(json.dumps(out))
'''


def main(parent, change):
    for tree in [parent, change, change, parent] * 2:
        res = subprocess.run([sys.executable, "-c", MEASURE, tree], cwd=tree, capture_output=True, text=True,
                             timeout=600)  # fmt: skip
        if res.returncode:
            print(res.stderr[-3000:], file=sys.stderr)
            return res.returncode
        print(json.dumps({"tree": tree, **json.loads(res.stdout.strip().splitlines()[-1])}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(*sys.argv[1:3]))
