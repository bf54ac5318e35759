"""L3a — vision front-end: ORB extraction, frames, camera model.

Array-program re-design of src/ORBExtractor.cpp, src/Frame.cpp, src/Camera.cpp:
the whole 8-level pyramid extraction compiles to a single XLA program per
image size (score maps + blocked reductions instead of per-cell loops);
frames are fixed-capacity arrays with validity masks.
"""

from irotavg_tpu.frontend.orb import ORBExtractor, OrbParams  # noqa: F401
from irotavg_tpu.frontend.camera import Camera  # noqa: F401
from irotavg_tpu.frontend.frame import Frame  # noqa: F401
from irotavg_tpu.frontend.prefetch import FramePrefetcher  # noqa: F401
from irotavg_tpu.frontend.sift import SIFTExtractor, SiftParams  # noqa: F401
