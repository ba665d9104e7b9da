"""Device memory watermark reporting (counterpart of
`montgomery_tpu/utils/memory.py`, the reference's printMaxSizeUsed,
memory-helpers.ts:266-276): the CUDA caching allocator's live and peak
bytes and the card's total memory, under the JAX package's keys."""

from __future__ import annotations

import torch


def device_memory_stats(device=None) -> dict:
    """{"peak_bytes_in_use", "bytes_in_use", "bytes_limit"} of a CUDA device
    (`torch.cuda.memory_stats` and the card's total memory); {} for the CPU.
    With no device, the current CUDA device: raises without one, as the
    package's other entry points do."""
    dev = torch.device("cuda", torch.cuda.current_device()) if device is None else torch.device(device)
    if dev.type == "cpu":
        return {}
    st = torch.cuda.memory_stats(dev)
    return {"peak_bytes_in_use": st.get("allocated_bytes.all.peak", 0),
            "bytes_in_use": st.get("allocated_bytes.all.current", 0),
            "bytes_limit": torch.cuda.get_device_properties(dev).total_memory}


def print_max_size_used(device=None, log=print) -> str:
    """One-line watermark report: live and peak bytes and the peak's share
    of the card. On the CPU it says that there are no stats (torch has no
    counterpart of the JAX package's `jax.live_arrays` lower bound)."""
    st = device_memory_stats(device)
    if not st:
        msg = "device memory: no stats on the CPU"
    else:
        peak, live, limit = st["peak_bytes_in_use"], st["bytes_in_use"], st["bytes_limit"] or 1
        msg = (f"device memory: live {live / 2**20:.0f} MB, peak {peak / 2**20:.0f} MB = "
               f"{100 * peak / limit:.0f}% of {limit / 2**30:.1f} GB")
    log(msg)
    return msg
