'''Published peaks of the card the benchmark runs on.

NVIDIA H100 SXM5 data sheet, dense rates (no sparsity), at its full power
limit of 700 W: 989 TFLOP/s in bf16 and fp16 on the tensor cores, 67 TFLOP/s
in float32 outside them, 3.35 TB/s of HBM3 bandwidth, 80 GB.
'''

PEAKS = {
    'NVIDIA H100 80GB HBM3': {'bf16_flops': 989e12, 'fp32_flops': 67e12,
                              'hbm_bytes_per_s': 3.35e12, 'memory_bytes': 80e9},
}


def peak(kind: str, name: str) -> float:
    '''The card ``kind``'s peak ``name``; a card not in the table has none.'''
    if kind not in PEAKS:
        raise KeyError(f'no published peaks for {kind!r}')
    return PEAKS[kind][name]
