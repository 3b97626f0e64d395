"""g2o pose-graph file I/O (benchmark config #2 'Intel/M3500 (g2o format)',
BASELINE.json:8).

Copy of ``pyslam_tpu/io/g2o.py`` (numpy only), with two differences: the
tokenizer is always the native C++ scanner (``pyslam_tpu_torch.native``,
built with ``g++`` at first use; a failed build raises, where the reference
falls back to Python), and ``read_g2o_switchable`` validates the vertex ids
of switchable edges.  The pure-Python tokenizer stays beside it as its plain
version (``_tokenize_g2o_plain``, for tests); both give the same record
matrices.

Supported records:
  VERTEX_SE2 id x y theta
  EDGE_SE2 i j dx dy dtheta  <6 upper-tri info entries>
  VERTEX_SE3:QUAT id x y z qx qy qz qw
  EDGE_SE3:QUAT i j dx dy dz qx qy qz qw  <21 upper-tri info entries>
  VERTEX_SIM3:QUAT id x y z qx qy qz qw s           (ORB-SLAM convention)
  EDGE_SIM3:QUAT i j dx dy dz qx qy qz qw s  <28 upper-tri info entries>
  VERTEX_XY id x y                                  (2D point landmark)
  EDGE_SE2_XY i j mx my <3 upper-tri info entries>  (landmark seen from pose)

Files containing landmark records parse to LandmarkSLAM2DData (2D landmark
SLAM, e.g. Victoria-Park-style datasets); pure pose files parse to
PoseGraphData.

Convention bridge: g2o vertices are body-to-world and the edge measurement is
M_ij = T_i^-1 @ T_j.  This framework follows the reference's world-to-body
convention (pyslam poses are T_b_w, SURVEY.md §3.2), where P = T^-1 and
M_ij = P_i @ P_j^-1 — i.e. a between factor with slots (j, i) and
T_obs = M_ij.  The readers/writers perform that mapping, so solving a loaded
g2o graph optimizes the standard g2o objective.
"""

from __future__ import annotations

import numpy as np

from .synth import LandmarkSLAM2DData, PoseGraphData



def _mat_to_quat(R):
    """3x3 rotation -> [qx, qy, qz, qw] (Shepperd's method)."""
    t = np.trace(R)
    if t > 0:
        w = 0.5 * np.sqrt(1 + t)
        f = 0.25 / w
        return np.array(
            [(R[2, 1] - R[1, 2]) * f, (R[0, 2] - R[2, 0]) * f, (R[1, 0] - R[0, 1]) * f, w]
        )
    i = int(np.argmax(np.diagonal(R)))
    j, k = (i + 1) % 3, (i + 2) % 3
    q = np.zeros(4)
    q[i] = 0.5 * np.sqrt(1 + R[i, i] - R[j, j] - R[k, k])
    f = 0.25 / q[i]
    q[j] = (R[j, i] + R[i, j]) * f
    q[k] = (R[k, i] + R[i, k]) * f
    q[3] = (R[k, j] - R[j, k]) * f
    return q


_G2O_ALIASES = {
    # legacy TORO/g2o aliases seen in published datasets
    "VERTEX2": "VERTEX_SE2", "EDGE2": "EDGE_SE2",
    "VERTEX3": "VERTEX_SE3:QUAT", "EDGE3": "EDGE_SE3:QUAT",
    "VERTEX_SE3": "VERTEX_SE3:QUAT", "EDGE_SE3": "EDGE_SE3:QUAT",
    "VERTEX_SIM3": "VERTEX_SIM3:QUAT", "EDGE_SIM3": "EDGE_SIM3:QUAT",
}
_G2O_WIDTH = {  # numeric fields per record (incl. integer id/index fields)
    "VERTEX_SE2": 4, "EDGE_SE2": 11,
    "VERTEX_SE3:QUAT": 8, "EDGE_SE3:QUAT": 30,
    "VERTEX_SIM3:QUAT": 9, "EDGE_SIM3:QUAT": 38,
    "VERTEX_XY": 3, "EDGE_SE2_XY": 7,
    # Vertigo switchable-constraint records (Suenderhauf's datasets:
    # manhattanOlson3500 with outliers, city10000, ...)
    "VERTEX_SWITCH": 2, "EDGE_SWITCH_PRIOR": 3,
    "EDGE_SE2_SWITCHABLE": 12, "EDGE_SE3_SWITCHABLE": 31,
}


def _tokenize_g2o(path) -> dict:
    """File -> {canonical tag: (N, width) f64 record matrix, file order}.

    One native pass (``native.scan_tagged``).  Unknown tags are skipped.
    Records reaching the same canonical tag through an alias keep file order
    within each spelling but are concatenated alias-after-canonical (id-keyed
    semantics downstream make this order-insensitive for well-formed files).
    """
    from .. import native

    with open(path, "rb") as f:
        buf = f.read()
    tags = list(_G2O_WIDTH) + list(_G2O_ALIASES)
    canon = list(_G2O_WIDTH) + [_G2O_ALIASES[a] for a in _G2O_ALIASES]
    ids, offs, cnts, fields = native.scan_tagged(buf, tags)
    groups: dict[str, list] = {}
    for k, ctag in enumerate(canon):
        sel = np.nonzero(ids == k)[0]
        if not len(sel):
            continue
        w = _G2O_WIDTH[ctag]
        if not np.all(cnts[sel] == w):
            bad = sel[np.nonzero(cnts[sel] != w)[0][0]]
            raise ValueError(f"{tags[k]} record with {cnts[bad]} fields (expected {w})")
        groups.setdefault(ctag, []).append(fields[offs[sel][:, None] + np.arange(w)])
    return {t: (v[0] if len(v) == 1 else np.concatenate(v, 0)) for t, v in groups.items()}


def _tokenize_g2o_plain(path) -> dict:
    """The plain version of ``_tokenize_g2o``: a Python loop with ``float()``
    a token, the same record matrices in the same order."""
    acc: dict[str, dict[str, list]] = {}
    with open(path) as f:
        for line in f:
            tok = line.split()
            if not tok:
                continue
            tag = _G2O_ALIASES.get(tok[0], tok[0])
            w = _G2O_WIDTH.get(tag)
            if w is None:
                continue
            vals = [float(x) for x in tok[1:]]
            if len(vals) != w:
                raise ValueError(
                    f"{tok[0]} record with {len(vals)} fields (expected {w})")
            acc.setdefault(tag, {}).setdefault(tok[0], []).append(vals)
    out = {}
    for tag, by_spelling in acc.items():
        # canonical spelling first, then the aliases in _G2O_ALIASES order
        order = [tag] + [a for a in _G2O_ALIASES if _G2O_ALIASES[a] == tag]
        parts = [np.asarray(by_spelling[t], np.float64) for t in order if t in by_spelling]
        out[tag] = parts[0] if len(parts) == 1 else np.concatenate(parts, 0)
    return out


def _quat_to_mat_batch(q):
    """(N, 4) [qx,qy,qz,qw] -> (N, 3, 3), normalizing like _quat_to_mat."""
    x, y, z, w = q[:, 0], q[:, 1], q[:, 2], q[:, 3]
    s = 2.0 / (q * q).sum(1)
    R = np.empty((len(q), 3, 3))
    R[:, 0, 0] = 1 - s * (y * y + z * z)
    R[:, 0, 1] = s * (x * y - z * w)
    R[:, 0, 2] = s * (x * z + y * w)
    R[:, 1, 0] = s * (x * y + z * w)
    R[:, 1, 1] = 1 - s * (x * x + z * z)
    R[:, 1, 2] = s * (y * z - x * w)
    R[:, 2, 0] = s * (x * z - y * w)
    R[:, 2, 1] = s * (y * z + x * w)
    R[:, 2, 2] = 1 - s * (x * x + y * y)
    return R


def _unpack_upper_batch(vals, d):
    """(N, d(d+1)/2) upper-tri rows -> (N, d, d) symmetric matrices."""
    r, c = np.triu_indices(d)
    out = np.zeros((len(vals), d, d))
    out[:, r, c] = vals
    out[:, c, r] = vals
    return out


def _sqrt_info_batch(info):
    """Batched PSD square root, matching scipy eigh elementwise.

    Diagonal information matrices (the common case in published g2o
    datasets) take the elementwise-sqrt shortcut; anything else pays one
    batched eigh."""
    d = info.shape[-1]
    r, c = np.triu_indices(d, k=1)
    if len(info) and not info[:, r, c].any():
        out = np.zeros_like(info)
        idx = np.arange(d)
        out[:, idx, idx] = np.sqrt(np.clip(info[:, idx, idx], 0.0, None))
        return out
    w, V = np.linalg.eigh(info)
    w = np.sqrt(np.clip(w, 0.0, None))
    return np.einsum("nij,nj,nkj->nik", V, w, V)


def _se2_mats(xyth):
    """(N, 3) [x,y,theta] -> (N, 3, 3) SE(2) matrices."""
    T = np.tile(np.eye(3), (len(xyth), 1, 1))
    c, s = np.cos(xyth[:, 2]), np.sin(xyth[:, 2])
    T[:, 0, 0] = c
    T[:, 0, 1] = -s
    T[:, 1, 0] = s
    T[:, 1, 1] = c
    T[:, :2, 2] = xyth[:, :2]
    return T


def _se3_mats(t, q, scale=None):
    """(N,3) translations + (N,4) quats [+ (N,) scales] -> (N,4,4)."""
    T = np.tile(np.eye(4), (len(t), 1, 1))
    R = _quat_to_mat_batch(q)
    T[:, :3, :3] = R if scale is None else scale[:, None, None] * R
    T[:, :3, 3] = t
    return T




def read_g2o(path, _recs=None) -> "PoseGraphData | LandmarkSLAM2DData":
    """Parse a g2o file into PoseGraphData — or LandmarkSLAM2DData when the
    file carries VERTEX_XY/EDGE_SE2_XY landmark records (world-to-body
    poses, between-factor slots already swapped per the convention bridge
    above).

    Two stages: tokenize (_tokenize_g2o, the native C++ scanner) then a
    fully-batched numpy assembly (one quat->R, inv, eigh call over each
    record batch instead of per-record Python).  ``_recs`` lets callers that
    already tokenized the file (the Vertigo reader, or a test with the plain
    tokenizer's records) skip the scan.
    """
    recs = _recs if _recs is not None else _tokenize_g2o(path)
    if not recs:
        raise ValueError(f"{path}: no recognized g2o records")
    sim3 = "VERTEX_SIM3:QUAT" in recs or "EDGE_SIM3:QUAT" in recs
    dim = 2 if ("VERTEX_SE2" in recs or "VERTEX_XY" in recs) else 3

    # Pose vertices -> (ids, body-to-world matrices), per-tag last-id-wins.
    if dim == 2:
        v = recs.get("VERTEX_SE2", np.zeros((0, 4)))
        vert_ids = v[:, 0].astype(np.int64)
        vert_T = _se2_mats(v[:, 1:4])
    else:
        parts = []
        if "VERTEX_SE3:QUAT" in recs:
            v = recs["VERTEX_SE3:QUAT"]
            parts.append((v[:, 0].astype(np.int64),
                          _se3_mats(v[:, 1:4], v[:, 4:8])))
        if "VERTEX_SIM3:QUAT" in recs:
            v = recs["VERTEX_SIM3:QUAT"]
            parts.append((v[:, 0].astype(np.int64),
                          _se3_mats(v[:, 1:4], v[:, 4:8], scale=v[:, 8])))
        vert_ids = np.concatenate([p[0] for p in parts])
        vert_T = np.concatenate([p[1] for p in parts])

    # Pose-pose edges -> (gi, gj, M, info) batches.
    if dim == 2:
        e = recs.get("EDGE_SE2", np.zeros((0, 11)))
        ei, ej = e[:, 0].astype(np.int64), e[:, 1].astype(np.int64)
        M = _se2_mats(e[:, 2:5])
        info = _unpack_upper_batch(e[:, 5:11], 3)
    elif not sim3:
        e = recs.get("EDGE_SE3:QUAT", np.zeros((0, 30)))
        ei, ej = e[:, 0].astype(np.int64), e[:, 1].astype(np.int64)
        M = _se3_mats(e[:, 2:5], e[:, 5:9])
        info = _unpack_upper_batch(e[:, 9:30], 6)
    else:
        if "EDGE_SE3:QUAT" in recs:
            raise ValueError("mixed SE3/SIM3 edge records are not supported")
        e = recs.get("EDGE_SIM3:QUAT", np.zeros((0, 38)))
        ei, ej = e[:, 0].astype(np.int64), e[:, 1].astype(np.int64)
        M = _se3_mats(e[:, 2:5], e[:, 5:9], scale=e[:, 9])
        info = _unpack_upper_batch(e[:, 10:38], 7)

    if "VERTEX_XY" in recs or "EDGE_SE2_XY" in recs:
        return _assemble_landmark_slam(
            vert_ids, vert_T, ei, ej, M, info,
            recs.get("VERTEX_XY", np.zeros((0, 3))),
            recs.get("EDGE_SE2_XY", np.zeros((0, 7))))

    # Pure pose graph: vertex ids must be dense 0..n-1 (reference layout).
    n = int(vert_ids.max()) + 1 if len(vert_ids) else 0
    d = 3 if dim == 2 else 4
    T_g2o = np.zeros((n, d, d))
    T_g2o[vert_ids] = vert_T  # duplicate ids: later record wins
    seen = np.zeros(n, bool)
    seen[vert_ids] = True
    if not seen.all():
        raise ValueError(f"missing vertex id {int(np.nonzero(~seen)[0][0])}")
    T_bw = np.linalg.inv(T_g2o)  # body-to-world -> world-to-body
    # between factor est = P_slot2 @ inv(P_slot1); M_ij = P_i @ P_j^-1
    # -> slots are (j, i)
    return PoseGraphData(
        dim, T_bw, T_bw.copy(), ej, ei, M, _sqrt_info_batch(info)
    )


def _dense_index(sorted_ids, query, what):
    """Map g2o ids -> dense indices via searchsorted, validating presence."""
    pos = np.searchsorted(sorted_ids, query)
    ok = (pos < len(sorted_ids)) & (sorted_ids[np.minimum(pos, len(sorted_ids) - 1)] == query)
    if not ok.all():
        raise ValueError(f"edge references unknown {what} id "
                         f"{int(query[np.nonzero(~ok)[0][0]])}")
    return pos


def _assemble_landmark_slam(vert_ids, vert_T, ei, ej, M, info,
                            lm_recs, lm_edge_recs) -> LandmarkSLAM2DData:
    """2D landmark-SLAM record batches -> LandmarkSLAM2DData.  g2o pose and
    landmark vertices share one id space and need not be contiguous; both
    are remapped to dense indices by sorted id.  The EDGE_SE2_XY measurement
    is the landmark in the observing pose's frame, which under the world-to-
    body bridge is exactly act(T, l) — the landmark_xy_se2 kernel's
    prediction (graph/factor_defs.py)."""
    pose_ids = np.unique(vert_ids)
    lm_ids = np.unique(lm_recs[:, 0].astype(np.int64))
    T_by_pos = np.zeros((len(pose_ids), 3, 3))
    T_by_pos[np.searchsorted(pose_ids, vert_ids)] = vert_T  # later id wins
    T_bw = np.linalg.inv(T_by_pos) if len(pose_ids) else np.zeros((0, 3, 3))
    lm = np.zeros((len(lm_ids), 2))
    lm[np.searchsorted(lm_ids, lm_recs[:, 0].astype(np.int64))] = lm_recs[:, 1:3]

    # pose-pose edges: our (slot1, slot2) = (j, i) in g2o terms
    edges_i = _dense_index(pose_ids, ej, "pose")
    edges_j = _dense_index(pose_ids, ei, "pose")
    T_meas = M
    sqrt_info = _sqrt_info_batch(info)

    obs_pose = _dense_index(pose_ids, lm_edge_recs[:, 0].astype(np.int64), "pose")
    obs_lm = _dense_index(lm_ids, lm_edge_recs[:, 1].astype(np.int64), "landmark")
    obs = lm_edge_recs[:, 2:4].copy()
    osi = _sqrt_info_batch(_unpack_upper_batch(lm_edge_recs[:, 4:7], 2))
    return LandmarkSLAM2DData(
        T_gt=T_bw,
        T_init=T_bw.copy(),
        lm_gt=lm,
        lm_init=lm.copy(),
        edges_i=edges_i,
        edges_j=edges_j,
        T_meas=T_meas,
        sqrt_info=sqrt_info,
        obs_pose=obs_pose,
        obs_lm=obs_lm,
        obs=obs,
        obs_sqrt_info=osi,
        obs_type="xy",
    )


def write_g2o_landmarks(path, data: LandmarkSLAM2DData, use_init: bool = True):
    """Write LandmarkSLAM2DData as VERTEX_SE2/VERTEX_XY/EDGE_SE2/EDGE_SE2_XY
    records (inverse of the landmark branch of read_g2o).  Landmark vertex
    ids follow the pose ids.  Only obs_type='xy' data round-trips — g2o has
    no standard bearing-range record."""
    if data.obs_type != "xy":
        raise ValueError("g2o landmark records are relative-position (obs_type='xy')")
    T = data.T_init if use_init else data.T_gt
    lm = data.lm_init if use_init else data.lm_gt
    n = len(T)
    with open(path, "w") as f:
        for i, P in enumerate(T):
            V = np.linalg.inv(P)
            th = np.arctan2(V[1, 0], V[0, 0])
            f.write(f"VERTEX_SE2 {i} {V[0, 2]:.9g} {V[1, 2]:.9g} {th:.9g}\n")
        for k, p in enumerate(lm):
            f.write(f"VERTEX_XY {n + k} {p[0]:.9g} {p[1]:.9g}\n")
        for k in range(len(data.edges_i)):
            gj, gi = int(data.edges_i[k]), int(data.edges_j[k])
            M = data.T_meas[k]
            th = np.arctan2(M[1, 0], M[0, 0])
            info = data.sqrt_info[k].T @ data.sqrt_info[k]
            up = [info[a, b] for a in range(3) for b in range(a, 3)]
            f.write(
                f"EDGE_SE2 {gi} {gj} {M[0, 2]:.9g} {M[1, 2]:.9g} {th:.9g} "
                + " ".join(f"{v:.9g}" for v in up)
                + "\n"
            )
        for k in range(len(data.obs_pose)):
            info = data.obs_sqrt_info[k].T @ data.obs_sqrt_info[k]
            up = [info[a, b] for a in range(2) for b in range(a, 2)]
            f.write(
                f"EDGE_SE2_XY {int(data.obs_pose[k])} {n + int(data.obs_lm[k])} "
                f"{data.obs[k, 0]:.9g} {data.obs[k, 1]:.9g} "
                + " ".join(f"{v:.9g}" for v in up)
                + "\n"
            )


def write_g2o(path, data: PoseGraphData, use_init: bool = True):
    """Write PoseGraphData to a g2o file (inverse of read_g2o)."""
    T = data.T_init if use_init else data.T_gt
    with open(path, "w") as f:
        if data.dim == 2:
            for i, P in enumerate(T):
                V = np.linalg.inv(P)  # world-to-body -> body-to-world
                th = np.arctan2(V[1, 0], V[0, 0])
                f.write(f"VERTEX_SE2 {i} {V[0, 2]:.9g} {V[1, 2]:.9g} {th:.9g}\n")
            for k in range(len(data.edges_i)):
                # our (slot1, slot2) = (j, i) in g2o terms
                gj, gi = int(data.edges_i[k]), int(data.edges_j[k])
                M = data.T_meas[k]
                th = np.arctan2(M[1, 0], M[0, 0])
                info = data.sqrt_info[k].T @ data.sqrt_info[k]
                up = [info[a, b] for a in range(3) for b in range(a, 3)]
                f.write(
                    f"EDGE_SE2 {gi} {gj} {M[0, 2]:.9g} {M[1, 2]:.9g} {th:.9g} "
                    + " ".join(f"{v:.9g}" for v in up)
                    + "\n"
                )
        else:
            is_sim3 = data.sqrt_info.shape[-1] == 7
            dof = 7 if is_sim3 else 6

            def _split(A):
                """(4,4) (possibly scaled) -> (t, q, s)."""
                s = float(np.cbrt(np.linalg.det(A[:3, :3]))) if is_sim3 else 1.0
                return A[:3, 3], _mat_to_quat(A[:3, :3] / s), s

            vtag = "VERTEX_SIM3:QUAT" if is_sim3 else "VERTEX_SE3:QUAT"
            etag = "EDGE_SIM3:QUAT" if is_sim3 else "EDGE_SE3:QUAT"
            for i, P in enumerate(T):
                t, q, s = _split(np.linalg.inv(P))
                row = list(t) + list(q) + ([s] if is_sim3 else [])
                f.write(f"{vtag} {i} " + " ".join(f"{v:.9g}" for v in row) + "\n")
            for k in range(len(data.edges_i)):
                gj, gi = int(data.edges_i[k]), int(data.edges_j[k])
                t, q, s = _split(data.T_meas[k])
                info = data.sqrt_info[k].T @ data.sqrt_info[k]
                up = [info[a, b] for a in range(dof) for b in range(a, dof)]
                row = list(t) + list(q) + ([s] if is_sim3 else []) + up
                f.write(f"{etag} {gi} {gj} " + " ".join(f"{v:.9g}" for v in row) + "\n")


def read_g2o_switchable(path):
    """Parse a Vertigo-format g2o file (Suenderhauf's switchable-constraint
    datasets: VERTEX_SWITCH / EDGE_SWITCH_PRIOR / EDGE_SE2_SWITCHABLE /
    EDGE_SE3_SWITCHABLE alongside the regular pose records).

    Returns ``(data, sw)``: ``data`` is PoseGraphData whose edge arrays are
    the regular edges followed by the switchable ones, and ``sw`` a dict
    with ``loop_mask`` (True on the appended switchable edges, per-edge),
    ``xi`` (per-switchable-edge prior stiffness, sqrt of the
    EDGE_SWITCH_PRIOR information scalar; 1.0 where absent) and ``s_init``
    (per-switchable-edge VERTEX_SWITCH initial values).  Feed straight into
    ``build.switchable_pose_graph(data, **sw)``."""
    import dataclasses

    recs = _tokenize_g2o(path)
    base = read_g2o(path, _recs=recs)  # one tokenization feeds both stages
    if isinstance(base, LandmarkSLAM2DData):
        # the base parse remapped non-contiguous pose ids; raw switchable
        # edge ids would index the wrong poses
        raise ValueError("switchable edges in a file with landmark records are not supported")
    if base.dim == 2:
        sw = recs.get("EDGE_SE2_SWITCHABLE", np.zeros((0, 12)))
        M = _se2_mats(sw[:, 3:6])
        info = _unpack_upper_batch(sw[:, 6:12], 3)
    else:
        sw = recs.get("EDGE_SE3_SWITCHABLE", np.zeros((0, 31)))
        M = _se3_mats(sw[:, 3:6], sw[:, 6:10])
        info = _unpack_upper_batch(sw[:, 10:31], 6)
    ei = sw[:, 0].astype(np.int64)
    ej = sw[:, 1].astype(np.int64)
    sid = sw[:, 2].astype(np.int64)
    n_poses = base.T_init.shape[0]
    for ids in (ei, ej):
        bad = (ids < 0) | (ids >= n_poses)
        if bad.any():
            raise ValueError(
                f"switchable edge references vertex id {int(ids[bad][0])} "
                f"outside [0, {n_poses})")

    vs = recs.get("VERTEX_SWITCH", np.zeros((0, 2)))
    if len(vs):
        s_ids = vs[:, 0].astype(np.int64)
        order = np.argsort(s_ids)
        s_ids_sorted = s_ids[order]
        s_vals = vs[order, 1]
    else:
        # files without VERTEX_SWITCH records: switch ids exist only on
        # the edges; default every initial value to 1
        s_ids_sorted = np.unique(sid)
        s_vals = np.ones(len(s_ids_sorted))
    xi_by_switch = np.ones(len(s_ids_sorted))
    sp = recs.get("EDGE_SWITCH_PRIOR", np.zeros((0, 3)))
    if len(sp):
        pos = _dense_index(s_ids_sorted, sp[:, 0].astype(np.int64), "switch")
        xi_by_switch[pos] = np.sqrt(np.clip(sp[:, 2], 0.0, None))
    sw_idx = (
        _dense_index(s_ids_sorted, sid, "switch")
        if len(sid)
        else np.zeros(0, np.int64)
    )

    n_reg = len(base.edges_i)
    data = dataclasses.replace(
        base,
        # our (slot1, slot2) = (j, i) in g2o terms, matching read_g2o
        edges_i=np.concatenate([base.edges_i, ej]),
        edges_j=np.concatenate([base.edges_j, ei]),
        T_meas=np.concatenate([base.T_meas, M]),
        sqrt_info=np.concatenate([base.sqrt_info, _sqrt_info_batch(info)]),
    )
    loop_mask = np.zeros(n_reg + len(ei), bool)
    loop_mask[n_reg:] = True
    return data, dict(
        loop_mask=loop_mask,
        xi=xi_by_switch[sw_idx],
        s_init=s_vals[sw_idx],
    )


def write_g2o_switchable(path, data, loop_mask, xi=5.0, s_init=None,
                         use_init: bool = True):
    """Write PoseGraphData as a Vertigo-format 2D file: regular records for
    non-loop edges, VERTEX_SWITCH + EDGE_SWITCH_PRIOR + EDGE_SE2_SWITCHABLE
    for the ``loop_mask`` edges (inverse of read_g2o_switchable; SE2 only —
    the published Vertigo datasets are 2D)."""
    import dataclasses

    if data.dim != 2:
        raise NotImplementedError("write_g2o_switchable supports SE2 only")
    loop_mask = np.asarray(loop_mask, bool)
    n_loops = int(loop_mask.sum())
    xi = np.broadcast_to(np.asarray(xi, np.float64), (n_loops,))
    s_init = (
        np.ones(n_loops) if s_init is None
        else np.broadcast_to(np.asarray(s_init, np.float64), (n_loops,))
    )
    odo = ~loop_mask
    base = dataclasses.replace(
        data,
        edges_i=np.asarray(data.edges_i)[odo],
        edges_j=np.asarray(data.edges_j)[odo],
        T_meas=np.asarray(data.T_meas)[odo],
        sqrt_info=np.asarray(data.sqrt_info)[odo],
    )
    write_g2o(path, base, use_init=use_init)
    n_poses = data.T_init.shape[0]
    li = np.asarray(data.edges_i)[loop_mask]
    lj = np.asarray(data.edges_j)[loop_mask]
    lM = np.asarray(data.T_meas)[loop_mask]
    lS = np.asarray(data.sqrt_info)[loop_mask]
    with open(path, "a") as f:
        for k in range(n_loops):
            sid = n_poses + k  # switch vertices share the g2o id space
            f.write(f"VERTEX_SWITCH {sid} {s_init[k]:.9g}\n")
            f.write(f"EDGE_SWITCH_PRIOR {sid} 1 {xi[k] ** 2:.9g}\n")
            gj, gi = int(li[k]), int(lj[k])  # slot convention inverse
            M = lM[k]
            th = np.arctan2(M[1, 0], M[0, 0])
            info = lS[k].T @ lS[k]
            up = [info[a, b] for a in range(3) for b in range(a, 3)]
            f.write(
                f"EDGE_SE2_SWITCHABLE {gi} {gj} {sid} "
                f"{M[0, 2]:.9g} {M[1, 2]:.9g} {th:.9g} "
                + " ".join(f"{v:.9g}" for v in up)
                + "\n"
            )
