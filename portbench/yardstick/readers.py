'''The arithmetic that the per-layer metric readers share. Each reader in
``portbench/metrics/`` calls one of these on a run's observations; each
returns None where the run holds nothing to read.'''
import statistics
from typing import Optional

from portbench.yardstick import flops
from portbench.yardstick.peaks import PEAKS, peak


def on_card(ctx) -> bool:
    '''Whether the run was on a card with published peaks: a run anywhere
    else reads no device metric.'''
    return ctx.kind in PEAKS


def idle_pct(ctx, out) -> Optional[float]:
    '''100 x (1 - device busy / traced window).'''
    if not on_card(ctx) or out.trace is None or out.trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - out.trace.busy_s / out.trace.window_s)


def mfu_pct(ctx, out, per_image) -> Optional[float]:
    '''The model's FLOPs for the window's images over its seconds, as a
    share of the card's bf16 peak.'''
    obs = out.observed
    images = obs.get('frames') or obs.get('images')
    if not on_card(ctx) or not images or not obs.get('window_s'):
        return None
    rate = per_image(obs['model']) * images / obs['window_s']
    return 100.0 * rate / peak(ctx.kind, 'bf16_flops')


def inference_mfu(ctx, out):
    return mfu_pct(ctx, out, flops.inference_flops_per_image)


def train_mfu(ctx, out):
    return mfu_pct(ctx, out, flops.train_flops_per_image)


def roofline_pct(ctx, out, kernel: str, bytes_key: str) -> Optional[float]:
    '''The bytes bound (least bytes over the HBM bandwidth) as a share of
    the kernel's device time in the trace.'''
    if not on_card(ctx) or out.trace is None or not out.observed.get(bytes_key):
        return None
    seconds, launches = out.trace.kernel_seconds(kernel)
    if launches == 0 or seconds <= 0:
        return None
    bound = out.observed[bytes_key] / peak(ctx.kind, 'hbm_bytes_per_s')
    return 100.0 * bound / seconds


def per(out, numerator: str, denominator: str) -> Optional[float]:
    '''A count of the program's per unit of the window's work.'''
    obs = out.observed
    if not obs.get(denominator):
        return None
    return obs[numerator] / obs[denominator]


def chunk_ms_per_frame(ctx, out) -> Optional[float]:
    '''The median window chunk's wall time per frame.'''
    obs = out.observed
    if not on_card(ctx) or not obs.get('chunk_s'):
        return None
    return 1000.0 * statistics.median(obs['chunk_s']) / obs['chunk_frames']
