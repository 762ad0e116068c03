"""The hand kernels' launches as a device trace shows them.

Each wrapper of `ops.psi` ends a call with exactly one closing kernel on
its stream: K1 with its chunk reduction `reduce_chunks<true>` (or
`reduce_tiled<true>` in the tiled form), K4 and K5 with the same
reduction `<false>` (one body without Psi1^T Y), K2 with `finish_kernel`
(`finish_tiled_kernel`) and K6 with `psi1_kernel`. Counting those in a
trace of the card (`torch.profiler`, whose CUPTI records see a CUDA
graph's replays kernel by kernel) counts the calls whose kernels really
ran, to set against `ops.psi.LAUNCHES`, which the wrappers count on the
host. K4 and K5 share their closing kernel, so both count as "psi2".
"""
from __future__ import annotations

import re

# a wrapper's `ops.psi.LAUNCHES` key -> the family its closing kernel names
FAMILY = {"suffstats_batched": "suffstats_batched",
          "psi2_bwd_batched": "psi2_bwd_batched",
          "psi2_batched": "psi2", "psi2_single": "psi2", "psi1": "psi1"}

# the closing kernels: (name, template arguments or None for any) -> family
_CLOSING = {("reduce_chunks", "<true>"): "suffstats_batched",
            ("reduce_tiled", "<true>"): "suffstats_batched",
            ("reduce_chunks", "<false>"): "psi2",
            ("reduce_tiled", "<false>"): "psi2",
            ("finish_kernel", None): "psi2_bwd_batched",
            ("finish_tiled_kernel", None): "psi2_bwd_batched",
            ("psi1_kernel", None): "psi1"}

# "void (anonymous namespace)::reduce_chunks<true>(float const*, ...)":
# the csrc kernels live in an anonymous namespace, a library's do not
_NAME = re.compile(r"^(?:void )?\(anonymous namespace\)::(\w+)(<[^(]*>)?\(")


def family_of(kernel_name: str) -> str | None:
    """The launch family whose closing kernel `kernel_name` (as the
    profiler prints it) is, or None."""
    m = _NAME.match(kernel_name)
    if m is None:
        return None
    name, args = m.group(1), m.group(2)
    return _CLOSING.get((name, args), _CLOSING.get((name, None)))


def families(launches: dict) -> dict:
    """Host launch counts keyed as `ops.psi.LAUNCHES` -> counts per
    family (K4 and K5 added)."""
    out = dict.fromkeys(sorted(set(FAMILY.values())), 0)
    for key, n in launches.items():
        out[FAMILY[key]] += n
    return out


def traced(kernels) -> dict:
    """Counts per family from (kernel name, count) pairs of a device
    trace, e.g. `(e.key, e.count) for e in prof.key_averages()` of the
    CUDA events."""
    out = dict.fromkeys(sorted(set(FAMILY.values())), 0)
    for name, count in kernels:
        fam = family_of(name)
        if fam is not None:
            out[fam] += count
    return out


def traced_launches(prof) -> tuple[dict, int]:
    """(counts per family, kernels in all) of a finished
    `torch.profiler.profile` that recorded CUDA activity."""
    kernels = [(e.key, e.count) for e in prof.key_averages()
               if "CUDA" in str(e.device_type)]
    return traced(kernels), sum(c for _, c in kernels)
