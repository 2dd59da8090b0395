"""Operations and bytes of the port's kernels, from their shapes: the
least a launch could take on the card is the larger of bytes over HBM
bandwidth and operations over the peak. Each input byte counts once and
each output byte once, whatever the kernel reads again."""
