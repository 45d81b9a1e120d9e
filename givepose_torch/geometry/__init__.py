from givepose_torch.geometry.rotations import (
    rot6d_to_mat,
    rot6d_fixed_x_to_mat,
    rot6d_fixed_y_to_mat,
    rot6d_fixed_z_to_mat,
    mat_to_rot6d,
    quat_to_mat,
    mat_to_quat,
    euler_to_mat,
    axangle_to_mat,
    lie_vec_to_mat,
    log_quat_to_mat,
    rot5d_to_mat,
    ortho5d_to_mat,
    get_rot_mat,
)
from givepose_torch.geometry.allo_ego import (
    allo_to_ego_mat,
    allo_to_ego_quat,
    ego_to_allo_mat,
    quat_mul,
)
from givepose_torch.geometry.pose_assembly import pose_from_pred_centroid_z
from givepose_torch.geometry.symmetry import (
    symmetry_rotation_bank_y,
    closest_sym_rot,
    sym_info_table,
)
from givepose_torch.geometry.errors import (
    rotation_error_deg,
    translation_error,
)
from givepose_torch.geometry.umeyama import (
    umeyama_similarity,
    ransac_umeyama,
    draw_hypotheses,
    backproject_depth,
)
