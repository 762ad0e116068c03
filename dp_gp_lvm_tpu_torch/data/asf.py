"""ASF skeleton parsing and forward kinematics for CMU mocap rendering
(counterpart of `dp_gp_lvm_tpu/data/asf.py`).

Parses the ASF skeleton definition, combines it with AMC joint-angle
frames (`parse_amc_frames`; the flat matrix for modelling is
`data/mocap.py::parse_amc`), and gives global 3D joint positions by the
standard CMU forward kinematics:

    C_bone   = Rz(az) Ry(ay) Rx(ax)            (bone 'axis', degrees)
    M_bone   = C · R_amc(dof angles) · C^{-1}   (local motion)
    R_global = R_parent · M_bone
    p_end    = p_parent_end + R_global · (length · direction)

Root: translation channels (TX, TY, TZ) plus its own axis-framed
rotation. Host numpy: rendering is off the training path.
"""
from __future__ import annotations

import numpy as np


def _rot_x(deg):
    r = np.deg2rad(deg)
    c, s = np.cos(r), np.sin(r)
    return np.array([[1, 0, 0], [0, c, -s], [0, s, c]])


def _rot_y(deg):
    r = np.deg2rad(deg)
    c, s = np.cos(r), np.sin(r)
    return np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]])


def _rot_z(deg):
    r = np.deg2rad(deg)
    c, s = np.cos(r), np.sin(r)
    return np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]])


def _axis_matrix(ax, ay, az):
    return _rot_z(az) @ _rot_y(ay) @ _rot_x(ax)


class Bone:
    __slots__ = ("name", "direction", "length", "c", "cinv", "dof",
                 "children")

    def __init__(self, name, direction, length, axis_deg, dof):
        self.name = name
        d = np.asarray(direction, float)
        n = np.linalg.norm(d)
        self.direction = d / n if n > 0 else d
        self.length = float(length)
        self.c = _axis_matrix(*axis_deg)
        self.cinv = np.linalg.inv(self.c)
        self.dof = list(dof)          # subset of ["rx", "ry", "rz"]
        self.children: list[str] = []


class Skeleton:
    def __init__(self):
        self.bones: dict[str, Bone] = {}
        self.root_order: list[str] = []   # e.g. TX TY TZ RX RY RZ
        self.root_axis = np.eye(3)
        self.root_axis_inv = np.eye(3)

    def joint_names(self):
        return ["root"] + list(self.bones.keys())


def parse_asf(path: str) -> Skeleton:
    sk = Skeleton()
    section = None
    bone_fields = None
    with open(path) as fh:
        lines = fh.readlines()
    i = 0
    while i < len(lines):
        line = lines[i].strip()
        i += 1
        if not line or line.startswith("#"):
            continue
        if line.startswith(":"):
            section = line.split()[0][1:]
            continue
        if section == "root":
            parts = line.split()
            if parts[0] == "order":
                sk.root_order = [p.upper() for p in parts[1:]]
            elif parts[0] == "axis":
                pass  # rotation order token (XYZ)
            elif parts[0] == "orientation":
                vals = [float(v) for v in parts[1:4]]
                sk.root_axis = _axis_matrix(*vals)
                sk.root_axis_inv = np.linalg.inv(sk.root_axis)
        elif section == "bonedata":
            if line == "begin":
                bone_fields = {"dof": [], "axis": (0.0, 0.0, 0.0)}
            elif line == "end":
                b = Bone(
                    bone_fields["name"],
                    bone_fields["direction"],
                    bone_fields["length"],
                    bone_fields["axis"],
                    bone_fields["dof"],
                )
                sk.bones[b.name] = b
                bone_fields = None
            elif bone_fields is not None:
                parts = line.split()
                key = parts[0]
                if key == "name":
                    bone_fields["name"] = parts[1]
                elif key == "direction":
                    bone_fields["direction"] = [float(v) for v in parts[1:4]]
                elif key == "length":
                    bone_fields["length"] = float(parts[1])
                elif key == "axis":
                    bone_fields["axis"] = tuple(float(v) for v in parts[1:4])
                elif key == "dof":
                    bone_fields["dof"] = [p.lower() for p in parts[1:]]
        elif section == "hierarchy":
            if line in ("begin", "end"):
                continue
            parts = line.split()
            parent, children = parts[0], parts[1:]
            if parent == "root":
                sk._root_children = children  # type: ignore[attr-defined]
            else:
                sk.bones[parent].children.extend(children)
    if not hasattr(sk, "_root_children"):
        sk._root_children = []  # type: ignore[attr-defined]
    if not sk.root_order:
        sk.root_order = ["TX", "TY", "TZ", "RX", "RY", "RZ"]
    return sk


def _bone_rotation(bone: Bone, frame: dict[str, list[float]]):
    vals = frame.get(bone.name, [])
    r = np.eye(3)
    # AMC stores values in the bone's dof order; apply as Rz @ Ry @ Rx
    angles = dict(zip(bone.dof, vals))
    m = np.eye(3)
    if "rx" in angles:
        m = _rot_x(angles["rx"]) @ m
    if "ry" in angles:
        m = _rot_y(angles["ry"]) @ m
    if "rz" in angles:
        m = _rot_z(angles["rz"]) @ m
    return bone.c @ m @ bone.cinv


def fk_frame(sk: Skeleton, frame: dict[str, list[float]]):
    """Global joint positions for one AMC frame.

    Returns (positions dict name -> (3,), segments list of (start, end))."""
    rootvals = frame.get("root", [0.0] * len(sk.root_order))
    ch = dict(zip(sk.root_order, rootvals))
    pos0 = np.array([ch.get("TX", 0.0), ch.get("TY", 0.0),
                     ch.get("TZ", 0.0)])
    m_root = np.eye(3)
    if any(k in ch for k in ("RX", "RY", "RZ")):
        m = _rot_z(ch.get("RZ", 0.0)) @ _rot_y(ch.get("RY", 0.0)) @ _rot_x(
            ch.get("RX", 0.0)
        )
        m_root = sk.root_axis @ m @ sk.root_axis_inv
    positions = {"root": pos0}
    segments = []

    def recurse(names, parent_pos, parent_rot):
        for name in names:
            b = sk.bones[name]
            rot = parent_rot @ _bone_rotation(b, frame)
            end = parent_pos + rot @ (b.length * b.direction)
            positions[name] = end
            segments.append((parent_pos.copy(), end.copy()))
            recurse(b.children, end, rot)

    recurse(sk._root_children, pos0, m_root)  # type: ignore[attr-defined]
    return positions, segments


def fk_sequence(sk: Skeleton, frames):
    """(N, J, 3) joint positions for a list of AMC frame dicts."""
    names = sk.joint_names()
    out = np.zeros((len(frames), len(names), 3))
    for i, fr in enumerate(frames):
        pos, _ = fk_frame(sk, fr)
        for j, n in enumerate(names):
            if n in pos:
                out[i, j] = pos[n]
    return out


def parse_amc_frames(path: str):
    """AMC file -> list of {bone: [values]} frame dicts (for FK; the
    flat-matrix variant for modeling lives in data/mocap.py)."""
    frames, current = [], None
    with open(path) as fh:
        for raw in fh:
            line = raw.strip()
            if not line or line.startswith("#") or line.startswith(":"):
                continue
            if line.isdigit():
                if current:
                    frames.append(current)
                current = {}
                continue
            if current is None:
                continue
            parts = line.split()
            current[parts[0]] = [float(v) for v in parts[1:]]
    if current:
        frames.append(current)
    return frames
