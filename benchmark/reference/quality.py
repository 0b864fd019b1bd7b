"""The codebook sizes an ETC1S quality level allows: a frozen copy of the
port's `compressor.etc1s_quality_to_clusters`, the reference encoder's
curves (basisu_comp.cpp:3325-3382)."""

MAX_CLUSTERS = 16128


def etc1s_clusters(quality_level: int, total_blocks: int):
    """(endpoint clusters, selector clusters) at most, for a quality level
    1-255 and the blocks of all of a texture's slices."""
    q = min(max(quality_level, 1), 255) / 255.0
    total_texels = total_blocks * 16.0
    max_endpoints = int(total_texels / 14.0)
    mid = 128.0 / 255.0
    if q <= mid:
        ceq = 0.5 * (q / mid) ** 0.65
        max_endpoints = min(max(min(max(max_endpoints, 256), 4800), 64),
                            total_blocks)
        endpoints = int(0.5 + 32 + (max_endpoints - 32) * ceq)
    else:
        ceq = ((q - mid) / (1.0 - mid)) ** 1.6
        max_endpoints = min(max(max_endpoints, 256), 8192)
        max_endpoints = max(min(max_endpoints, total_blocks), 4800)
        endpoints = int(0.5 + 4800 + (max_endpoints - 4800) * ceq)
    endpoints = min(max(endpoints, 32), MAX_CLUSTERS)

    max_selectors = min(max(int(total_texels / 14.0), 256), MAX_CLUSTERS)
    max_selectors = max(min(max_selectors, total_blocks), 96)
    selectors = int(0.5 + 96 + (max_selectors - 96) * q ** 2.62)
    return endpoints, min(max(selectors, 8), MAX_CLUSTERS)
