"""Preprocessing throughput: the host scipy chain against the device-batched route of
``Preprocessor.make_windows_batch`` (``scripts/bench_preprocess.py``).

The host route runs each sequence through unit scaling, scipy's ``medfilt`` on each
channel, the z-score and the window loop; the device route takes the sequences a
padding bucket at a time through one fused program (``data/preprocess.py``). Both see
the same 64 sequences of 1000-4000 samples of N(0, 8000²) counts from
``np.random.default_rng(0)``, as the JAX script draws them; parsing files is in
neither. Each route is timed with ``profile_step.median_ms`` (one pass over every
sequence a trial, after a warm-up pass); it prints sequences/s, windows/s and ms a
sequence.

Runs on the card unless ``--cpu``:
``python -m tpuhar_torch.scripts.bench_preprocess [--cpu]``
"""
from __future__ import annotations

import argparse
import json

import numpy as np

from ._common import card_line, log, per_s, script_device, shown

N_SEQUENCES, LENGTHS = 64, (1000, 4000)
TRIALS = 3


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--cpu", action="store_true", help="run on the CPU (default: the card)")
    return p.parse_args(argv)


def sequences(n: int = N_SEQUENCES, lengths=LENGTHS):
    npr = np.random.default_rng(0)
    return [npr.normal(0, 8000, size=(int(m), 6)).astype(np.float32) for m in npr.integers(*lengths, size=n)]


def run(*, cpu: bool = False, n_sequences: int = N_SEQUENCES, lengths=LENGTHS, trials: int = TRIALS) -> dict:
    """``{"bench", "sequences", "windows", "device", "host": {...}, "device_batched":
    {...}}``, each route's ``sequences_per_s``, ``windows_per_s`` and ``ms_per_seq``."""
    from ..config import Config
    from ..data.preprocess import Preprocessor
    from ..profile_step import median_ms

    device = script_device(cpu)
    card = card_line(device)
    cfg = Config()
    seqs = sequences(n_sequences, lengths)
    result = {"bench": "preprocess", "sequences": len(seqs), "windows": None, "device": card}
    for backend, key in (("host", "host"), ("device", "device_batched")):
        cfg.data.featurize_backend = backend
        pp = Preprocessor(cfg, device=device)
        windows = sum(len(w) for w in pp.make_windows_batch(seqs))
        result["windows"] = windows
        ms = median_ms(pp.make_windows_batch, (seqs,), trials=trials, iters=1, warmup=1, device=device)
        per_seq = None if ms is None else ms / len(seqs)
        result[key] = {"sequences_per_s": per_s(len(seqs), ms), "windows_per_s": per_s(windows, ms),
                       "ms_per_seq": per_seq}
        log(f"{key:15}: {shown(per_s(len(seqs), ms), '7.1f')} sequences/s {shown(per_s(windows, ms), '8.0f')} "
            f"windows/s ({shown(per_seq, '6.2f')} ms/seq) ({card})")
    print(json.dumps(result))
    return result


def main(argv=None):
    return run(cpu=parse_args(argv).cpu)


if __name__ == "__main__":
    main()
