"""What the forward kernels' ablation scripts share (scripts/ablate_fwd_torch.py,
scripts/ablate_fwd_dense_torch.py): the card's name and power limit, the
kernel's source with a variant's edits, the variants built at once into
blim_tpu_torch/_build/ and bound, and the table of times. Not a script.

A variant is a list of edits (text in the kernel's source, its replacement,
times the text occurs); each builds with the port's nvcc flags, one nvcc per
variant, all started together, and prints its ptxas spills and any wgmma
serialization.
"""

from __future__ import annotations

import ctypes
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def card() -> str:
    """`nvidia-smi`'s name and power limit of the card, printed first."""
    line = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60).stdout.strip()
    print(line, flush=True)
    return line


def variant_source(text: str, edits) -> str:
    for old, new, times in edits:
        if text.count(old) != times:
            raise SystemExit(f"the kernel's source holds this text {text.count(old)} times, "
                             f"not {times}: {old!r}")
        text = text.replace(old, new)
    return text


def slug(name: str) -> str:
    return "ablate_" + re.sub(r"[^a-z0-9]+", "_", name.lower()).strip("_")


def build_variants(kernel: str, variants: dict) -> dict:
    """{variant name: its library, bound as `kernel`'s}."""
    from blim_tpu_torch.kernels import flash_attention as fa

    source = fa.SOURCES[kernel]
    text = source.read_text()
    for name, edits in variants.items():
        folder = fa.BUILD_ROOT / f"ablate_{kernel}" / slug(name)
        folder.mkdir(parents=True, exist_ok=True)
        for header in source.parent.glob("*.cuh"):
            (folder / header.name).write_text(header.read_text())
        (folder / source.name).write_text(variant_source(text, edits))
        fa.SOURCES[slug(name)] = folder / source.name
    reports = fa.build(tuple(slug(name) for name in variants))    # one nvcc each, all at once
    libs = {}
    for name in variants:
        report = reports[slug(name)]
        spills = sorted({int(n) for n in re.findall(r"(\d+) bytes spill (?:stores|loads)", report)})
        serialized = [ln.strip() for ln in report.splitlines() if "serializ" in ln]
        print(f"[build] {name}: spill bytes {spills or 'not rebuilt'}"
              + (f"; wgmma serialized: {serialized[0][:160]}" if serialized else ""), flush=True)
        libs[name] = fa.bind(ctypes.CDLL(str(fa.library_path(slug(name)))), kernel)
    return libs


def print_times(title: str, times: dict, width: int = 44) -> None:
    """One line a variant: its times by round, its best, and the best's
    change against the kernel as built."""
    base = min(times["as built"])
    print(title, flush=True)
    for name, ts in times.items():
        best = min(ts)
        print(f"  {name:{width}s} {', '.join(f'{t:.4f}' for t in ts)} ms; best {best:.4f} "
              f"({100 * (best - base) / base:+.1f}% against as built)", flush=True)
