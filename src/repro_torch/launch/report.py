"""Render the dry run's tables from reports/dryrun_torch.json.

Usage:
    PYTHONPATH=src python -m repro_torch.launch.report [PATH]
"""
from __future__ import annotations

import json
import sys


def render(path: str = "reports/dryrun_torch.json") -> str:
    with open(path) as f:
        results = json.load(f)
    out = []

    def fmt_bytes(b):
        return f"{b/1e9:.2f}"

    # --- dry-run table (both meshes) --------------------------------------
    out.append("### Dry-run results\n")
    out.append("| arch | shape | mesh | status | args GB/dev | temp GB/dev "
               "| compile s |")
    out.append("|---|---|---|---|---|---|---|")
    key = lambda r: (r["arch"], r["shape"], r["mesh"])  # noqa: E731
    for r in sorted(results, key=key):
        if r["status"] == "OK":
            ma = r.get("memory_analysis", {})
            out.append(
                f"| {r['arch']} | {r['shape']} | {r['mesh']} | OK | "
                f"{fmt_bytes(ma.get('argument_size_in_bytes', 0))} | "
                f"{fmt_bytes(ma.get('temp_size_in_bytes', 0))} | "
                f"{r.get('roofline', {}).get('compile_seconds', 0):.0f} |")
        elif r["status"] == "SKIP":
            out.append(f"| {r['arch']} | {r['shape']} | {r['mesh']} | SKIP "
                       f"| - | - | - |")
        else:
            out.append(f"| {r['arch']} | {r['shape']} | {r['mesh']} | "
                       f"FAIL: {r.get('error', '')[:60]} | - | - | - |")

    # --- roofline table (single-pod) ---------------------------------------
    out.append("\n### Roofline (16x16, 256 chips, H100 constants)\n")
    out.append("| arch | shape | compute s | memory s | collective s | "
               "dominant | MODEL/HLO flops |")
    out.append("|---|---|---|---|---|---|---|")
    for r in sorted(results, key=key):
        if r["status"] != "OK" or r["mesh"] != "16x16" \
                or "roofline" not in r:
            continue
        rf = r["roofline"]
        out.append(
            f"| {r['arch']} | {r['shape']} | {rf['compute_s']:.3e} | "
            f"{rf['memory_s']:.3e} | {rf['collective_s']:.3e} | "
            f"**{rf['dominant']}** | {rf['useful_ratio']:.3f} |")
    return "\n".join(out)


if __name__ == "__main__":
    print(render(sys.argv[1] if len(sys.argv) > 1 else
                 "reports/dryrun_torch.json"))
