"""L4 two-view geometry: batched essential-matrix RANSAC + pose recovery.

Replaces the reference's cv::findEssentialMat(RANSAC)/cv::recoverPose calls
(src/ViewGraph.cpp:600-650) with batched linear algebra: minimal
samples are a leading batch axis, hypothesis solves are batched closed-form
null vectors, Sampson scoring is one dense (S, N) reduction, and cheirality runs
all four (R, t) decompositions over all points at once.
"""

from irotavg_tpu.geometry.essential import (  # noqa: F401
    ransac_essential,
    recover_pose,
    sampson_distance,
)
from irotavg_tpu.geometry.twoview import (  # noqa: F401
    RelativePose,
    find_relative_pose,
    refine_pose,
)
