"""Host-side (numpy, float64) instance of the SE3/quaternion math.

Used by the odometry driver, datasets, and evaluation, which keep trajectory
state in float64 on the host while the device compute path runs float32.
"""

import numpy as np

from ct_icp_torch.core.math_impl import build

_m = build(np)

quat_normalize = _m.quat_normalize
quat_mul = _m.quat_mul
quat_conj = _m.quat_conj
quat_rotate = _m.quat_rotate
quat_to_matrix = _m.quat_to_matrix
quat_from_matrix = _m.quat_from_matrix
quat_from_rotvec = _m.quat_from_rotvec
quat_slerp = _m.quat_slerp
angular_distance_deg = _m.angular_distance_deg
se3_apply = _m.se3_apply
se3_compose = _m.se3_compose
se3_inverse = _m.se3_inverse
se3_interpolate = _m.se3_interpolate
se3_matrix = _m.se3_matrix
alpha_timestamp = _m.alpha_timestamp
