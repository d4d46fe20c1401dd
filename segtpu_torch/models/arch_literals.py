"""Released architecture genotypes (a copy of
segtpu/models/arch_literals.py; provisional stand-ins there, and so
here, until the reference notebook's literals are available).

Each micro entry: genotype = [cell_config, conns] (see micro_decoders).
"""

ARCHS = {
    # mixes sep-convs, a dilated conv, GAP branch — exercises most ops
    "arch0": [
        [2, [0, 1, 3, 4], [2, 0, 5, 2], [1, 3, 8, 0]],
        [[3, 2], [4, 1], [5, 0]],
    ],
    # lighter: more skips and 1x1s
    "arch1": [
        [0, [1, 0, 9, 2], [0, 2, 2, 4], [3, 1, 0, 9]],
        [[3, 2], [2, 4], [1, 0]],
    ],
    # smallest: dominated by skip/sep3x3
    "arch2": [
        [9, [0, 1, 2, 9], [1, 2, 9, 0], [0, 3, 9, 2]],
        [[2, 3], [4, 1], [5, 0]],
    ],
}

# WACV'20 template-family stand-ins: [[conn, conn, op, op], ...] per block
TEMPLATE_ARCHS = {
    "template0": [[3, 2, 0, 2], [4, 1, 1, 4], [5, 0, 0, 9]],
}
