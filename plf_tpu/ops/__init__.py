from .plf_xla import plf_xla, plf_lane_major, plf_node
from . import layout
