"""L4 matching primitives (src/ViewGraph.cpp:125-569, array re-design).

Each reference matcher walks candidate lists per keypoint (BoW-node
buckets, epipolar gating, spatial-grid windows).  Here every matcher is
the same dense program: one (N1, N2) XOR+popcount Hamming matrix, a
boolean candidate mask (node equality / epipolar distance / search
radius), a masked best+second-best reduction, then vectorised ratio,
threshold, mutual-consistency and rotation-histogram post-filters.
"""

from irotavg_tpu.matching.matchers import (  # noqa: F401
    TH_LOW,
    match_by_bow,
    match_epipolar,
    match_locally,
    match_sift,
    matches_to_pairs,
    rotation_consistency_filter,
)
