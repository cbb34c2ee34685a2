'''Connected components of binary masks and each frame's largest one.

Port of ``moseq2_detectron_extract_tpu/ops/cc.py`` (lines 1-75). Labels
start as each foreground pixel's flat index + 1 and spread by sweeps: each
sweep gives every run of foreground pixels along a row, then every run
along a column, the largest label in it (what the reference's forward and
backward segmented max-scans compute). The sweeps are as many as the
reference's ``num_sweeps``, so a shape that needs more (a spiral) is left
with the same unconverged labels, and the largest component, and the
winner on a tie (the smallest label), are the reference's.
'''
import torch


def _run_max(labels: torch.Tensor, fg: torch.Tensor, dim: int) -> torch.Tensor:
    '''Each run of ``fg`` along ``dim`` takes its largest label; background
    stays 0. A run is numbered by the background pixels before it on its
    line, and lines by their place, so one ``amax`` scatter over all runs
    does it.'''
    moved = labels.movedim(dim, -1)
    fg_m = fg.movedim(dim, -1)
    length = moved.shape[-1]
    lines = moved.numel() // max(length, 1)
    run = torch.cumsum((~fg_m).to(torch.int64), dim=-1)
    line = torch.arange(lines, device=labels.device).reshape(moved.shape[:-1])[..., None]
    seg = (line * (length + 1) + run).reshape(-1)
    best = torch.zeros(lines * (length + 1), dtype=labels.dtype, device=labels.device)
    best = best.scatter_reduce(0, seg, moved.reshape(-1), reduce='amax', include_self=True)
    out = torch.where(fg_m, best[seg].reshape(moved.shape), torch.zeros_like(moved))
    return out.movedim(-1, dim)


def connected_components(masks: torch.Tensor, num_sweeps: int = 8) -> torch.Tensor:
    '''4-connected component labels of (N, H, W) masks -> int32 (N, H, W):
    positive labels, one per component once the sweeps have converged,
    background 0.'''
    fg = masks.to(torch.bool)
    n, h, w = fg.shape
    lin = torch.arange(1, h * w + 1, dtype=torch.int64, device=fg.device).reshape(1, h, w)
    labels = torch.where(fg, lin, torch.zeros((), dtype=torch.int64, device=fg.device))
    for _ in range(num_sweeps):
        labels = _run_max(labels, fg, 2)       # rows
        labels = _run_max(labels, fg, 1)       # columns
    return labels.to(torch.int32)


def largest_cc(masks: torch.Tensor, num_sweeps: int = 8) -> torch.Tensor:
    '''Boolean (N, H, W) mask of each frame's largest 4-connected
    component; on a tie the smallest label wins (``argmax``'s first), and an
    empty frame gives all False.'''
    fg = masks.to(torch.bool)
    n, h, w = fg.shape
    labels = connected_components(fg, num_sweeps=num_sweeps).to(torch.int64)
    bins = h * w + 1
    frame = torch.arange(n, device=fg.device)[:, None] * bins
    sizes = torch.bincount((labels.reshape(n, -1) + frame).reshape(-1),
                           minlength=n * bins).reshape(n, bins)
    sizes[:, 0] = 0                            # background never wins
    best = torch.argmax(sizes, dim=1)[:, None, None]
    return (labels == best) & (best > 0)
