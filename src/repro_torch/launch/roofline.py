"""Roofline analysis over the dry-run artifacts, for the H100.

Port of ``repro/launch/roofline.py``.  Reads ``build/dryrun/*.json``
(written by ``repro_torch.launch.dryrun``) and derives, per (arch x
shape x mesh), the three roofline terms of one H100 SXM (constants in
``launch.mesh``):

  compute term    = FLOPs_per_card      / peak bf16 FLOP/s
  memory term     = bytes_per_card      / HBM bytes/s
  collective term = wire_bytes_per_card / NVLink bytes/s

The artifact numbers are per card already (``op_analysis`` counts the
local ops of rank 0).  The single collective term prices all traffic
at NVLink's rate, the traffic over the data axis between nodes
(InfiniBand) too: the JAX package's single-link simplification, kept.
Each row also names the torch version that traced it and whether the
combo was traced as the baseline, without activation constraints
(``launch.dryrun``).  Also reported: MODEL_FLOPS = 6*N*D (train) /
2*N*D (prefill, decode) with N = active params, the useful-compute
ratio MODEL_FLOPS / FLOPs, the dominant term, and a one-line note on
what would move it.

  PYTHONPATH=src python -m repro_torch.launch.roofline             # table
  PYTHONPATH=src python -m repro_torch.launch.roofline --markdown
  PYTHONPATH=src python -m repro_torch.launch.roofline --csv
  PYTHONPATH=src python -m repro_torch.launch.roofline --inject FILE.md
"""
from __future__ import annotations

import argparse
import contextlib
import glob
import io
import json
import os
import re
from dataclasses import dataclass
from typing import Dict, List

from repro_torch.configs import ARCH_REGISTRY, INPUT_SHAPES, get_config
from repro_torch.launch.mesh import HBM_BW, LINK_BW, PEAK_FLOPS

ART_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                       "build", "dryrun")

_CHIPS = {"h100_32x8": 256, "h100_2x32x8": 512}


@dataclass
class RooflineRow:
    arch: str
    shape: str
    mesh: str
    accum: int
    compute_s: float
    memory_s: float
    collective_s: float
    model_flops: float          # per-card useful model FLOPs
    hlo_flops: float            # per-card counted FLOPs (the JAX name)
    bound_s: float              # max of the three = roofline step time
    dominant: str
    useful_ratio: float
    note: str
    torch: str                  # the torch version that traced the combo
    baseline: bool              # traced as the dry run's baseline
    raw: dict

    @property
    def roofline_fraction(self) -> float:
        """Useful compute time over the roofline-bound step time (1.0
        would be every cycle doing a useful model FLOP)."""
        if self.bound_s <= 0:
            return 0.0
        return (self.model_flops / PEAK_FLOPS) / self.bound_s


def model_flops_per_chip(arch: str, shape_name: str, chips: int,
                         accum: int = 1) -> float:
    """6*N*D train / 2*N*D forward, N = active params, D = tokens, over
    the card count."""
    cfg = get_config(arch)
    shape = INPUT_SHAPES[shape_name]
    n_active = cfg.param_count(active_only=True)
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len * accum
        total = 6.0 * n_active * tokens
    elif shape.kind == "prefill":
        if cfg.is_encoder_decoder:
            # encoder-decoder "prefill": encode the frames and take ONE
            # decode step (whisper: 1500 frames)
            tokens = shape.global_batch * (cfg.num_prefix_tokens + 1)
        else:
            tokens = shape.global_batch * shape.seq_len
        total = 2.0 * n_active * tokens
    else:  # decode: one token per request
        total = 2.0 * n_active * shape.global_batch
    return total / chips


def _suggestion(dominant: str, row: dict, arch: str, shape: str) -> str:
    cfg = ARCH_REGISTRY[arch]
    per = row.get("per_collective", {})
    big = max(per, key=per.get) if per else ""
    if dominant == "collective":
        if big == "all-gather":
            return ("all-gather dominates: overlap weight gathers with "
                    "compute, keep them on NVLink, or batch the gathers")
        if big == "all-reduce":
            return ("all-reduce dominates: reduce-scatter + local update "
                    "(ZeRO) or accumulate more before syncing (AdLoCo's "
                    "own lever)")
        return f"{big} dominates: reschedule or overlap it"
    if dominant == "memory":
        if shape.startswith("decode"):
            return ("KV-cache streaming bound (expected for 1-token "
                    "decode): bigger per-card batch or a quantized cache")
        return ("HBM bound: fuse elementwise chains (eager runs one "
                "kernel per op), use the flash kernel, or raise the "
                "per-card batch")
    if cfg.arch_type == "moe":
        return "compute bound (good): tensor-core-align expert matmuls"
    return "compute bound (good): near the useful-FLOP roof"


def load_rows(art_dir: str = ART_DIR) -> List[RooflineRow]:
    rows: List[RooflineRow] = []
    for fn in sorted(glob.glob(os.path.join(art_dir, "*.json"))):
        with open(fn) as f:
            r = json.load(f)
        if r.get("status") != "ok" or r.get("shape") == "adloco_outer":
            continue
        chips = _CHIPS.get(r["mesh"], 1)
        accum = int(r.get("accum", 1))
        c_s = r["flops"] / PEAK_FLOPS
        m_s = r["bytes_accessed"] / HBM_BW
        k_s = r["collective_wire_bytes"] / LINK_BW
        mf = model_flops_per_chip(r["arch"], r["shape"], chips, accum)
        terms = {"compute": c_s, "memory": m_s, "collective": k_s}
        dominant = max(terms, key=terms.get)
        rows.append(RooflineRow(
            arch=r["arch"], shape=r["shape"], mesh=r["mesh"], accum=accum,
            compute_s=c_s, memory_s=m_s, collective_s=k_s,
            model_flops=mf, hlo_flops=r["flops"],
            bound_s=max(terms.values()), dominant=dominant,
            useful_ratio=mf / max(r["flops"], 1.0),
            note=_suggestion(dominant, r, r["arch"], r["shape"]),
            torch=r.get("torch", "unknown"),
            baseline=bool(r.get("baseline", False)), raw=r))
    return rows


def baseline_rows(rows: List[RooflineRow]) -> List[RooflineRow]:
    """The rows without accumulation (the baseline table)."""
    return [r for r in rows if r.accum == 1]


def fmt_s(x: float) -> str:
    if x >= 1.0:
        return f"{x:7.2f}s "
    if x >= 1e-3:
        return f"{x * 1e3:7.2f}ms"
    return f"{x * 1e6:7.1f}us"


def print_table(rows: List[RooflineRow], markdown: bool = False) -> None:
    if markdown:
        print("| arch | shape | mesh | compute | memory | collective | "
              "bound | dominant | MFLOPs/FLOPs | roofline frac | torch | "
              "baseline |")
        print("|---|---|---|---|---|---|---|---|---|---|---|---|")
        for r in rows:
            print(f"| {r.arch} | {r.shape} | {r.mesh} | "
                  f"{fmt_s(r.compute_s).strip()} | "
                  f"{fmt_s(r.memory_s).strip()} | "
                  f"{fmt_s(r.collective_s).strip()} | "
                  f"{fmt_s(r.bound_s).strip()} | "
                  f"**{r.dominant}** | {r.useful_ratio:.2f} | "
                  f"{r.roofline_fraction:.2f} | {r.torch} | "
                  f"{'yes' if r.baseline else 'no'} |")
        return
    hdr = (f"{'arch':22s} {'shape':12s} {'mesh':12s} {'compute':9s} "
           f"{'memory':9s} {'collect':9s} {'dominant':10s} "
           f"{'useful':7s} {'rooffrac':8s} {'torch':14s} baseline")
    print(hdr)
    print("-" * len(hdr))
    for r in rows:
        print(f"{r.arch:22s} {r.shape:12s} {r.mesh:12s} "
              f"{fmt_s(r.compute_s)} {fmt_s(r.memory_s)} "
              f"{fmt_s(r.collective_s)} {r.dominant:10s} "
              f"{r.useful_ratio:6.2f}  {r.roofline_fraction:6.2f}   "
              f"{r.torch:14s} {'yes' if r.baseline else 'no'}")


def print_csv(rows: List[RooflineRow]) -> None:
    print("arch,shape,mesh,compute_s,memory_s,collective_s,dominant,"
          "useful_ratio,roofline_fraction,torch,baseline")
    for r in rows:
        print(f"{r.arch},{r.shape},{r.mesh},{r.compute_s:.6g},"
              f"{r.memory_s:.6g},{r.collective_s:.6g},{r.dominant},"
              f"{r.useful_ratio:.4f},{r.roofline_fraction:.4f},{r.torch},"
              f"{int(r.baseline)}")


def pick_hillclimb_pairs(rows: List[RooflineRow]) -> Dict[str, RooflineRow]:
    """Worst roofline fraction, most collective-bound, and most
    representative of the paper's technique, on the one-pod mesh.

    Decode shapes are left out of 'worst': a 1-token step streams the
    whole KV cache for one multiply-add per byte and has no story
    beyond 'batch more requests'."""
    single = [r for r in rows if r.mesh == "h100_32x8" and r.accum == 1]
    big = [r for r in single if r.shape in ("train_4k", "prefill_32k")]
    worst = min(big, key=lambda r: r.roofline_fraction)
    coll = max((r for r in big if r is not worst),
               key=lambda r: r.collective_s /
               max(r.compute_s, r.memory_s, 1e-12))
    train = [r for r in single if r.shape == "train_4k"
             and r is not worst and r is not coll]
    # the technique targets the training outer sync: the biggest train
    # config moves the most bytes per sync
    rep = max(train, key=lambda r: r.raw.get("params", 0))
    return {"worst_roofline": worst, "most_collective": coll,
            "paper_representative": rep}


def inject(path: str, art_dir: str = ART_DIR) -> None:
    """Replace the <!-- ROOFLINE_TABLE --> marker (or a block injected
    before) in the markdown file ``path`` with the current table."""
    rows = baseline_rows(load_rows(art_dir))
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        print("<!-- ROOFLINE_TABLE -->")
        print_table([r for r in rows if r.mesh == "h100_32x8"],
                    markdown=True)
        multi = [r for r in rows if r.mesh == "h100_2x32x8"]
        if multi:
            print()
            print("Two pods (2 x 32 x 8, 512 cards); terms are per card:")
            print()
            print_table(multi, markdown=True)
        print("<!-- /ROOFLINE_TABLE -->")
    with open(path) as f:
        text = f.read()
    block = buf.getvalue().rstrip()
    if "<!-- /ROOFLINE_TABLE -->" in text:
        text = re.sub(r"<!-- ROOFLINE_TABLE -->.*?<!-- /ROOFLINE_TABLE -->",
                      lambda _: block, text, flags=re.S)
    else:
        text = text.replace("<!-- ROOFLINE_TABLE -->", block)
    with open(path, "w") as f:
        f.write(text)
    print(f"[roofline] table injected -> {path}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawTextHelpFormatter)
    ap.add_argument("--markdown", action="store_true")
    ap.add_argument("--csv", action="store_true")
    ap.add_argument("--mesh", default=None, choices=sorted(_CHIPS))
    ap.add_argument("--dir", default=ART_DIR, help="artifact directory")
    ap.add_argument("--pick", action="store_true",
                    help="print the three hillclimb pairs")
    ap.add_argument("--inject", default=None, metavar="FILE_MD",
                    help="write the table into a markdown file in place")
    args = ap.parse_args(argv)
    if args.inject:
        inject(args.inject, args.dir)
        return 0
    rows = baseline_rows(load_rows(args.dir))
    if args.mesh:
        rows = [r for r in rows if r.mesh == args.mesh]
    if args.csv:
        print_csv(rows)
    else:
        print_table(rows, markdown=args.markdown)
    if args.pick:
        print()
        for why, r in pick_hillclimb_pairs(load_rows(args.dir)).items():
            print(f"[pick] {why:22s} -> {r.arch} x {r.shape} "
                  f"(dominant={r.dominant}, frac={r.roofline_fraction:.3f})")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
