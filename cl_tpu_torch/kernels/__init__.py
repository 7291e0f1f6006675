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
