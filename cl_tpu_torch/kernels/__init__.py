"""Wrappers of the hand-written CUDA kernels, each beside its plain PyTorch version."""

# Blocks a sum over pixels is split over (the dW kernels): two per SM of an
# H100 SXM. Fixed, not read from the card, so the partial sums run in the
# same order on every card.
SPLIT_BLOCKS = 2 * 132

# The H100 SXM's SMs and the shared memory an SM holds (228 KB, of which
# the runtime keeps 1 KB a resident block): what the dW kernels' split
# pickers size one wave of resident blocks by. Fixed, not read from the
# card, for the same reason.
SM_COUNT = 132
SMEM_PER_SM = 233472
SMEM_RESERVED_PER_BLOCK = 1024


def resident_blocks(smem_bytes, min_blocks):
    """Blocks of a kernel an SM holds: ``min_blocks`` (its
    ``__launch_bounds__``, which fits the registers to that many) unless
    its dynamic shared memory allows fewer."""
    return max(1, min(min_blocks, SMEM_PER_SM // (smem_bytes + SMEM_RESERVED_PER_BLOCK)))


def one_wave_splits(n_units, channel_tiles, blocks_per_sm):
    """Splits of ``n_units`` (pixel tiles or slices) over the blocks of one
    channel tile, for one wave of resident blocks: as many splits as the
    card holds beside the channel tiles, then as few as give each block
    the same number of rounds. At least one, at most ``n_units``."""
    splits = max(1, SM_COUNT * blocks_per_sm // channel_tiles)
    rounds = -(-n_units // splits)
    return max(1, -(-n_units // rounds))


def _launch_counters():
    from cl_tpu_torch.kernels import (augment, ce_loss, conv3x3, conv3x3_g2, ewc_fused, head_ce,
                                      kd_loss, packed_eltwise, pool_pack, replay_gather,
                                      upconv_pack)

    return (head_ce.LAUNCHES, ce_loss.LAUNCHES, kd_loss.LAUNCHES, conv3x3.LAUNCHES,
            conv3x3_g2.LAUNCHES, packed_eltwise.LAUNCHES, pool_pack.LAUNCHES,
            upconv_pack.LAUNCHES, ewc_fused.LAUNCHES, replay_gather.LAUNCHES, augment.LAUNCHES)


def reset_launches() -> None:
    """Every wrapper's launch count to 0 (each wrapper adds one where it
    launches its kernel)."""
    for d in _launch_counters():
        for k in d:
            d[k] = 0


def read_launches() -> dict:
    """Every wrapper's launch count, by kernel key."""
    out = {}
    for d in _launch_counters():
        out.update(d)
    return out
