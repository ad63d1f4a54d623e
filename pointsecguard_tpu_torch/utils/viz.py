"""Point-cloud viewers of the port (port of
``pointsecguard_tpu/utils/viz.py:16-34,75-166``: the interactive HTML
viewer). The equivalent of the reference's open3d / VTK windows
(`helper_tool.py:264-330`, `ResGCN/utils/pc_viz.py`) as a self-contained
file. The JAX package's matplotlib ``render_cloud`` is not ported: no
ported path reads it.
"""

from __future__ import annotations

import numpy as np

from pointsecguard_tpu_torch.utils.logging import label_palette


def _prepare_cloud(xyz, colors, labels, max_points):
    """The viewer's preprocessing: a deterministic subsample to
    ``max_points``, labels → palette colours, 0–255 → [0, 1]. Returns (xyz,
    colors); colors is None when neither colours nor labels were given."""
    if len(xyz) > max_points:
        sel = np.random.RandomState(0).choice(len(xyz), max_points, replace=False)
        xyz = xyz[sel]
        colors = None if colors is None else np.asarray(colors)[sel]
        labels = None if labels is None else np.asarray(labels)[sel]
    if colors is None and labels is not None:
        labels = np.asarray(labels).astype(int)
        colors = label_palette(labels.max() + 1)[labels] / 255.0
    elif colors is not None:
        colors = np.asarray(colors, np.float64)
        if colors.max() > 1.0:
            colors = colors / 255.0
    return xyz, colors


_HTML_TEMPLATE = """<!DOCTYPE html>
<html>
<head>
<meta charset="utf-8"/>
<title>{title}</title>
<style>html,body{{margin:0;height:100%;overflow:hidden;background:#111}}
#info{{position:absolute;top:8px;left:12px;color:#ddd;
font:13px sans-serif;user-select:none}}</style>
</head>
<body>
<div id="info">{title} — {n} points (drag: rotate, wheel: zoom,
right-drag: pan)</div>
<script type="importmap">{{"imports":{{
 "three":"https://cdn.jsdelivr.net/npm/three@0.160.0/build/three.module.js",
 "three/addons/":"https://cdn.jsdelivr.net/npm/three@0.160.0/examples/jsm/"
}}}}</script>
<script type="module">
import * as THREE from 'three';
import {{OrbitControls}} from 'three/addons/controls/OrbitControls.js';
const pos = new Float32Array({positions});
const col = new Float32Array({colors});
const scene = new THREE.Scene();
const geom = new THREE.BufferGeometry();
geom.setAttribute('position', new THREE.BufferAttribute(pos, 3));
geom.setAttribute('color', new THREE.BufferAttribute(col, 3));
geom.computeBoundingSphere();
const bs = geom.boundingSphere;
const mat = new THREE.PointsMaterial({{size: bs.radius/220,
  vertexColors: true}});
scene.add(new THREE.Points(geom, mat));
const cam = new THREE.PerspectiveCamera(
  55, innerWidth/innerHeight, bs.radius/1000, bs.radius*20);
cam.position.set(bs.center.x + bs.radius*1.6, bs.center.y + bs.radius*1.6,
  bs.center.z + bs.radius*1.1);
const renderer = new THREE.WebGLRenderer({{antialias: true}});
renderer.setSize(innerWidth, innerHeight);
document.body.appendChild(renderer.domElement);
const controls = new OrbitControls(cam, renderer.domElement);
controls.target.copy(bs.center);
addEventListener('resize', () => {{
  cam.aspect = innerWidth/innerHeight; cam.updateProjectionMatrix();
  renderer.setSize(innerWidth, innerHeight);
}});
(function animate() {{requestAnimationFrame(animate);
  controls.update(); renderer.render(scene, cam);}})();
</script>
</body>
</html>
"""


def export_html_viewer(
    path: str,
    xyz: np.ndarray,
    colors: np.ndarray | None = None,
    labels: np.ndarray | None = None,
    *,
    title: str = "point cloud",
    max_points: int = 400_000,
) -> str:
    """Write a self-contained interactive HTML point-cloud viewer: the JAX
    package's page with the same numbers.

    It stands in for the reference's interactive windows
    (`helper_tool.py:264-330` open3d ``draw_geometries``,
    `ResGCN/utils/pc_viz.py` VTK) on a headless host. The file embeds the
    cloud and renders it with three.js + OrbitControls, which the viewing
    browser fetches: drag to rotate, wheel to zoom.

    Args:
      xyz: [N, 3] positions.
      colors: [N, 3] colours in [0, 1] or 0–255; or
      labels: [N] class labels, coloured by ``label_palette``.
      title: the page's title.
      max_points: a larger cloud is subsampled (seeded) to this many.

    Returns:
      ``path``.
    """
    xyz, colors = _prepare_cloud(
        np.asarray(xyz, np.float32).reshape(-1, 3), colors, labels, max_points
    )
    if colors is None:
        colors = np.full_like(xyz, 0.8)
    else:
        colors = np.asarray(colors).reshape(-1, 3)

    def js_array(a):
        # the JAX package's np.array2string(threshold=inf) is quadratic in
        # the cloud's size (minutes for a room of 400k points); the same
        # numbers at the same 4 decimals, without its alignment spaces
        return "[" + ",".join(np.char.mod("%.4f", np.asarray(a, np.float32).reshape(-1))) + "]"

    html = _HTML_TEMPLATE.format(
        title=title, n=len(xyz),
        positions=js_array(xyz), colors=js_array(colors),
    )
    with open(path, "w") as f:
        f.write(html)
    return path
