"""Traffic generators, driven by the parameter files beside this module
(traffic/<mix>.json).  Every mix is drawn with numpy: the shapes of the
work (lengths, gaps, frequencies) from the mix's own `shape_seed`, the
order of the lengths and the token ids from --seed, so that every seed
offers the same amount of work in another order."""

from __future__ import annotations

import json
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np

DIRECTORY = Path(__file__).resolve().parent


def load(name: str, directory: Path = DIRECTORY) -> dict:
    path = Path(directory) / f"{name}.json"
    if not path.is_file():
        raise SystemExit(f"no traffic mix {name!r} ({path})")
    return json.loads(path.read_text())


def _lognormal(rng, spec: dict, count: int) -> np.ndarray:
    """`count` integers lognormal around spec's median with spec's sigma,
    clipped to [min, max]."""
    values = rng.lognormal(np.log(spec["median"]), spec["sigma"], count)
    return np.clip(np.rint(values), spec["min"], spec["max"]).astype(int)


@dataclass
class Request:
    index: int
    due_s: float                  # seconds after the window opens
    prompt: np.ndarray            # (prompt_len,) int32
    max_new: int
    in_window: bool               # due before the window closes
    first_token_s: float | None = None
    admitted_step_s: float | None = None    # start of the admitting step
    token_times: list = field(default_factory=list)
    tokens: list = field(default_factory=list)


def _within_octaves(rng, lengths: np.ndarray) -> np.ndarray:
    """`lengths` permuted by `rng` within each power-of-two class
    (2**(k-1), 2**k]: every position keeps its class."""
    classes = np.ceil(np.log2(lengths)).astype(int)
    permuted = lengths.copy()
    for value in np.unique(classes):
        where = np.flatnonzero(classes == value)
        permuted[where] = lengths[rng.permutation(where)]
    return permuted


def open_loop(mix: dict, seed: int, seconds: float, vocab: int,
              cycles: int = 3) -> list:
    """Requests of an open loop at mix["rate_per_s"]: n = round(rate x
    seconds) requests due inside the window, their arrival gaps
    exponential with the n gaps scaled to fill the window exactly, the
    prompt and output lengths lognormal; then `cycles` - 1 more rounds
    of the same schedule after the window, to keep the load on while
    the window's requests finish.  The due times and the lengths come
    from the mix's shape_seed.  --seed draws the token ids and orders
    the lengths within each power-of-two class, so every arrival keeps
    its time and the class of its prompt and output: the tail over a
    window's few requests is set by which prefill lands in which burst
    of arrivals, and every seed offers the same bursts of the same
    work."""
    shapes = np.random.default_rng(int(mix["shape_seed"]))
    count = max(1, int(round(float(mix["rate_per_s"]) * seconds)))
    prompts = _lognormal(shapes, mix["prompt_tokens"], count)
    outputs = _lognormal(shapes, mix["output_tokens"], count)
    gaps = shapes.exponential(1.0, count)
    gaps *= seconds / gaps.sum()
    due = np.concatenate([[0.0], np.cumsum(gaps)[:-1]])
    rng = np.random.default_rng(int(seed))
    requests = []
    for cycle in range(cycles):
        lengths = _within_octaves(rng, prompts)
        news = _within_octaves(rng, outputs)
        for slot in range(count):
            requests.append(Request(
                index=len(requests), due_s=float(seconds * cycle + due[slot]),
                prompt=rng.integers(0, vocab, int(lengths[slot]),
                                    dtype=np.int32),
                max_new=int(news[slot]), in_window=cycle == 0))
    return requests


def residents(mix: dict, seed: int, count: int, vocab: int,
              first_index: int) -> list:
    """`count` requests of the mix already being served when the window
    opens (the population an engine holds in the steady state): their
    lengths from the mix's shape_seed + 1, their ids from --seed."""
    shapes = np.random.default_rng(int(mix["shape_seed"]) + 1)
    prompts = _lognormal(shapes, mix["prompt_tokens"], count)
    outputs = _lognormal(shapes, mix["output_tokens"], count)
    rng = np.random.default_rng([int(seed), 1])
    order = rng.permutation(count)
    return [Request(index=first_index + position, due_s=float("-inf"),
                    prompt=rng.integers(0, vocab, int(prompts[slot]),
                                        dtype=np.int32),
                    max_new=int(outputs[slot]), in_window=False)
            for position, slot in enumerate(order)]


def tones(mix: dict, seed: int, device) -> np.ndarray:
    """(pool_frames, rows, samples) float32 host audio: each row a sum of
    mix["tones_per_row"] sinusoids at frequencies uniform in
    mix["freq_hz"], amplitudes uniform in (0.1, 1) and random phases,
    plus white noise of mix["noise"] rms.  The frequencies, amplitudes,
    phases and the noise's seed come from --seed (numpy); the samples
    are synthesized in bulk on `device` (phases in float64) and copied
    to the host once."""
    import torch
    rng = np.random.default_rng(int(seed))
    frames, rows = int(mix["pool_frames"]), int(mix["rows"])
    samples = int(mix["seconds_audio"] * mix["sample_rate"])
    shape = (frames, rows, int(mix["tones_per_row"]), 1)
    low, high = mix["freq_hz"]
    freqs = torch.from_numpy(rng.uniform(low, high, shape)).to(device)
    amps = torch.from_numpy(rng.uniform(0.1, 1.0, shape)).to(device)
    phases = torch.from_numpy(rng.uniform(0.0, 2 * np.pi, shape)).to(device)
    generator = torch.Generator(device=device).manual_seed(
        int(rng.integers(0, 2**62)))
    t = torch.arange(samples, dtype=torch.float64,
                     device=device) / mix["sample_rate"]
    audio = torch.empty((frames, rows, samples), dtype=torch.float32,
                        device=device)
    for frame in range(frames):
        cycles = torch.frac(freqs[frame] * t)          # (rows, tones, T)
        wave = (amps[frame] * torch.sin(2 * np.pi * cycles
                                        + phases[frame])).sum(dim=1)
        noise = torch.randn((rows, samples), generator=generator,
                            device=device) * float(mix["noise"])
        audio[frame] = wave.float() + noise
    return audio.cpu().numpy()
