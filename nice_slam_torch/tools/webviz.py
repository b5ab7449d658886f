"""Live browser-based SLAM viewer; the port's counterpart of the JAX
package's ``tools/webviz.py``.

The reference ships an interactive Open3D GUI (src/tools/viz.py:45-209)
that streams the reconstructed mesh, the estimated and ground-truth
trajectories and the camera frustum while SLAM runs.  Open3D needs a
display, which a card's host rarely has, so this frontend serves the
same scene over HTTP to any browser instead: a self-contained WebGL page
(no external JS, no network) with orbit controls, polling for mesh
updates and new poses.  The stdlib and numpy only.

Endpoints: ``/`` the page, ``/state`` the JSON of the trajectory, the
frustum and the mesh version, ``/mesh.bin`` the mesh (vertex and face
counts as two little-endian u32, the f32 vertices, the u8 colours padded
to 4 bytes, the u32 faces).  The same interface as the other frontends
(``tools/viz.py``): ``update_mesh(path)``, ``update_pose(idx, c2w)``,
``finalize_video()``.

Usage:
    python -m nice_slam_torch.visualizer CONFIG --frontend web [--port 8765]
then open http://localhost:8765/ .
"""

from __future__ import annotations

import json
import struct
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import List, Optional

import numpy as np

_PAGE = """<!doctype html>
<html><head><meta charset="utf-8"><title>nice_slam_torch viewer</title>
<style>
 body { margin:0; background:#111; color:#ddd; font:13px monospace; overflow:hidden }
 #hud { position:fixed; top:8px; left:8px; background:#000a; padding:6px 10px;
        border-radius:4px; pointer-events:none }
 canvas { display:block }
</style></head>
<body>
<div id="hud">connecting...</div>
<canvas id="c"></canvas>
<script>
"use strict";
const canvas = document.getElementById("c");
const hud = document.getElementById("hud");
const gl = canvas.getContext("webgl", {antialias:true});

function sh(type, src) {
  const s = gl.createShader(type); gl.shaderSource(s, src); gl.compileShader(s);
  if (!gl.getShaderParameter(s, gl.COMPILE_STATUS))
    throw gl.getShaderInfoLog(s);
  return s;
}
function prog(vs, fs) {
  const p = gl.createProgram();
  gl.attachShader(p, sh(gl.VERTEX_SHADER, vs));
  gl.attachShader(p, sh(gl.FRAGMENT_SHADER, fs));
  gl.linkProgram(p); return p;
}
const meshProg = prog(
 `attribute vec3 aPos; attribute vec3 aCol; attribute vec3 aNrm;
  uniform mat4 uMVP; uniform mat3 uRot; varying vec3 vCol;
  void main() {
    gl_Position = uMVP * vec4(aPos, 1.0);
    float l = 0.55 + 0.45 * abs((uRot * aNrm).z);
    vCol = aCol * l;
  }`,
 `precision mediump float; varying vec3 vCol;
  void main() { gl_FragColor = vec4(vCol, 1.0); }`);
const lineProg = prog(
 `attribute vec3 aPos; uniform mat4 uMVP;
  void main() { gl_Position = uMVP * vec4(aPos, 1.0); gl_PointSize = 4.0; }`,
 `precision mediump float; uniform vec3 uCol;
  void main() { gl_FragColor = vec4(uCol, 1.0); }`);

// ---- minimal mat4 ----
function mat4mul(a, b) {
  const o = new Float32Array(16);
  for (let i = 0; i < 4; i++) for (let j = 0; j < 4; j++) {
    let s = 0; for (let k = 0; k < 4; k++) s += a[k*4+j] * b[i*4+k];
    o[i*4+j] = s;
  } return o;
}
function persp(fovy, asp, n, f) {
  const t = 1 / Math.tan(fovy / 2);
  return new Float32Array([t/asp,0,0,0, 0,t,0,0, 0,0,(f+n)/(n-f),-1,
                           0,0,2*f*n/(n-f),0]);
}
function lookRot(yaw, pitch) {
  const cy = Math.cos(yaw), sy = Math.sin(yaw);
  const cp = Math.cos(pitch), sp = Math.sin(pitch);
  // rows of R (world->cam)
  return [ [cy, 0, -sy], [sy*sp, cp, cy*sp], [sy*cp, -sp, cy*cp] ];
}

let center = [0,0,0], dist = 6, yaw = 0.6, pitch = 0.5;
let meshBuf = null, nTris = 0, trajBufs = {est:null, gt:null},
    trajN = {est:0, gt:0}, frustum = null, nFrustum = 0;
let meshVersion = -1, nVerts = 0, lastIdx = -1;

function viewProj() {
  const R = lookRot(yaw, pitch);
  const eye = [center[0] + dist * R[2][0], center[1] + dist * R[2][1],
               center[2] + dist * R[2][2]];
  const V = new Float32Array(16);
  for (let r = 0; r < 3; r++) {
    V[0*4+r] = R[r][0]; V[1*4+r] = R[r][1]; V[2*4+r] = R[r][2];
    V[3*4+r] = -(R[r][0]*eye[0] + R[r][1]*eye[1] + R[r][2]*eye[2]);
  }
  V[15] = 1;
  const P = persp(0.9, canvas.width / canvas.height, 0.05, 300);
  return {mvp: mat4mul(P, V), rot: R};
}

function draw() {
  canvas.width = innerWidth; canvas.height = innerHeight;
  gl.viewport(0, 0, canvas.width, canvas.height);
  gl.clearColor(0.07, 0.07, 0.08, 1);
  gl.enable(gl.DEPTH_TEST);
  gl.clear(gl.COLOR_BUFFER_BIT | gl.DEPTH_BUFFER_BIT);
  const {mvp, rot} = viewProj();
  const rot3 = new Float32Array([rot[0][0],rot[1][0],rot[2][0],
                                 rot[0][1],rot[1][1],rot[2][1],
                                 rot[0][2],rot[1][2],rot[2][2]]);
  if (meshBuf) {
    gl.useProgram(meshProg);
    gl.uniformMatrix4fv(gl.getUniformLocation(meshProg, "uMVP"), false, mvp);
    gl.uniformMatrix3fv(gl.getUniformLocation(meshProg, "uRot"), false, rot3);
    gl.bindBuffer(gl.ARRAY_BUFFER, meshBuf);
    const stride = 36;
    const locP = gl.getAttribLocation(meshProg, "aPos");
    const locC = gl.getAttribLocation(meshProg, "aCol");
    const locN = gl.getAttribLocation(meshProg, "aNrm");
    gl.enableVertexAttribArray(locP);
    gl.vertexAttribPointer(locP, 3, gl.FLOAT, false, stride, 0);
    gl.enableVertexAttribArray(locC);
    gl.vertexAttribPointer(locC, 3, gl.FLOAT, false, stride, 12);
    gl.enableVertexAttribArray(locN);
    gl.vertexAttribPointer(locN, 3, gl.FLOAT, false, stride, 24);
    gl.drawArrays(gl.TRIANGLES, 0, nTris * 3);
  }
  for (const [key, col] of [["est", [1.0, 0.3, 0.2]], ["gt", [0.3, 1.0, 0.3]]]) {
    if (!trajBufs[key] || trajN[key] < 2) continue;
    gl.useProgram(lineProg);
    gl.uniformMatrix4fv(gl.getUniformLocation(lineProg, "uMVP"), false, mvp);
    gl.uniform3fv(gl.getUniformLocation(lineProg, "uCol"), col);
    gl.bindBuffer(gl.ARRAY_BUFFER, trajBufs[key]);
    const loc = gl.getAttribLocation(lineProg, "aPos");
    gl.enableVertexAttribArray(loc);
    gl.vertexAttribPointer(loc, 3, gl.FLOAT, false, 0, 0);
    gl.drawArrays(gl.LINE_STRIP, 0, trajN[key]);
  }
  if (frustum && nFrustum) {
    gl.useProgram(lineProg);
    gl.uniformMatrix4fv(gl.getUniformLocation(lineProg, "uMVP"), false, mvp);
    gl.uniform3fv(gl.getUniformLocation(lineProg, "uCol"), [0.3, 0.7, 1.0]);
    gl.bindBuffer(gl.ARRAY_BUFFER, frustum);
    const loc = gl.getAttribLocation(lineProg, "aPos");
    gl.enableVertexAttribArray(loc);
    gl.vertexAttribPointer(loc, 3, gl.FLOAT, false, 0, 0);
    gl.drawArrays(gl.LINES, 0, nFrustum);
  }
  requestAnimationFrame(draw);
}

// ---- orbit controls ----
let drag = null;
canvas.addEventListener("mousedown", e => drag = [e.clientX, e.clientY]);
addEventListener("mouseup", () => drag = null);
addEventListener("mousemove", e => {
  if (!drag) return;
  yaw   += (e.clientX - drag[0]) * 0.008;
  pitch += (e.clientY - drag[1]) * 0.008;
  pitch = Math.max(-1.5, Math.min(1.5, pitch));
  drag = [e.clientX, e.clientY];
});
addEventListener("wheel", e => { dist *= Math.exp(e.deltaY * 0.001); });

async function loadMesh(version) {
  const buf = await (await fetch("/mesh.bin?v=" + version)).arrayBuffer();
  const dv = new DataView(buf);
  const nv = dv.getUint32(0, true), nt = dv.getUint32(4, true);
  nVerts = nv;
  const verts = new Float32Array(buf, 8, nv * 3);
  const cols  = new Uint8Array(buf, 8 + nv * 12, nv * 3);
  const tris  = new Uint32Array(buf, 8 + nv * 12 + ((nv * 3 + 3) & ~3), nt * 3);
  // expand to non-indexed interleaved [pos3 col3 nrm3] (webgl1: u16 index cap)
  const out = new Float32Array(nt * 3 * 9);
  for (let t = 0; t < nt; t++) {
    const i0 = tris[t*3], i1 = tris[t*3+1], i2 = tris[t*3+2];
    const ax = verts[i1*3]-verts[i0*3], ay = verts[i1*3+1]-verts[i0*3+1],
          az = verts[i1*3+2]-verts[i0*3+2];
    const bx = verts[i2*3]-verts[i0*3], by = verts[i2*3+1]-verts[i0*3+1],
          bz = verts[i2*3+2]-verts[i0*3+2];
    let nx = ay*bz-az*by, ny = az*bx-ax*bz, nz = ax*by-ay*bx;
    const l = Math.hypot(nx, ny, nz) || 1; nx/=l; ny/=l; nz/=l;
    for (let k = 0; k < 3; k++) {
      const vi = tris[t*3+k], o = (t*3+k)*9;
      out[o]   = verts[vi*3]; out[o+1] = verts[vi*3+1]; out[o+2] = verts[vi*3+2];
      out[o+3] = cols[vi*3]/255; out[o+4] = cols[vi*3+1]/255;
      out[o+5] = cols[vi*3+2]/255;
      out[o+6] = nx; out[o+7] = ny; out[o+8] = nz;
    }
  }
  if (!meshBuf) meshBuf = gl.createBuffer();
  gl.bindBuffer(gl.ARRAY_BUFFER, meshBuf);
  gl.bufferData(gl.ARRAY_BUFFER, out, gl.STATIC_DRAW);
  nTris = nt;
  // recentre the orbit on first load
  if (nv && meshVersion < 0) {
    let mn = [1e9,1e9,1e9], mx = [-1e9,-1e9,-1e9];
    for (let i = 0; i < nv; i++) for (let k = 0; k < 3; k++) {
      mn[k] = Math.min(mn[k], verts[i*3+k]);
      mx[k] = Math.max(mx[k], verts[i*3+k]);
    }
    center = [(mn[0]+mx[0])/2, (mn[1]+mx[1])/2, (mn[2]+mx[2])/2];
    dist = 1.6 * Math.hypot(mx[0]-mn[0], mx[1]-mn[1], mx[2]-mn[2]);
  }
  meshVersion = version;
}

function setLines(key, pts) {
  if (!trajBufs[key]) trajBufs[key] = gl.createBuffer();
  gl.bindBuffer(gl.ARRAY_BUFFER, trajBufs[key]);
  gl.bufferData(gl.ARRAY_BUFFER, new Float32Array(pts.flat()), gl.DYNAMIC_DRAW);
  trajN[key] = pts.length;
}

async function poll() {
  try {
    const st = await (await fetch("/state")).json();
    if (st.mesh_version >= 0 && st.mesh_version !== meshVersion)
      await loadMesh(st.mesh_version);
    setLines("est", st.est);
    if (st.gt && st.gt.length) setLines("gt", st.gt);
    if (st.frustum && st.frustum.length) {
      if (!frustum) frustum = gl.createBuffer();
      gl.bindBuffer(gl.ARRAY_BUFFER, frustum);
      gl.bufferData(gl.ARRAY_BUFFER, new Float32Array(st.frustum.flat()),
                    gl.DYNAMIC_DRAW);
      nFrustum = st.frustum.length;
    }
    lastIdx = st.idx;
    hud.textContent = `frame ${st.idx}  mesh v${st.mesh_version} ` +
      `(${nVerts} verts, ${nTris} tris)  est ${st.est.length} poses` +
      (st.done ? "  [run finished]" : "");
  } catch (e) { hud.textContent = "poll error: " + e; }
  setTimeout(poll, 1000);
}
poll();
draw();
</script></body></html>
"""


def _frustum_lines(c2w: np.ndarray, scale: float) -> List[List[float]]:
    """Camera frustum wireframe as LINES pairs (SLAM convention, -z
    forward)."""
    pts = np.array([
        [0, 0, 0],
        [-0.6, -0.45, -1.0], [0.6, -0.45, -1.0],
        [0.6, 0.45, -1.0], [-0.6, 0.45, -1.0],
    ]) * scale
    pts = pts @ c2w[:3, :3].T + c2w[:3, 3]
    edges = [(0, 1), (0, 2), (0, 3), (0, 4), (1, 2), (2, 3), (3, 4), (4, 1)]
    out: List[List[float]] = []
    for a, b in edges:
        out.append([float(v) for v in pts[a]])
        out.append([float(v) for v in pts[b]])
    return out


def mesh_blob(verts: np.ndarray, tris: np.ndarray, colors) -> bytes:
    """The ``/mesh.bin`` payload of a mesh (grey where it has no colours)."""
    verts = np.ascontiguousarray(verts, np.float32)
    tris = np.ascontiguousarray(tris, np.uint32)
    if colors is None:
        colors = np.full((len(verts), 3), 180, np.uint8)
    colors = np.ascontiguousarray(colors, np.uint8)
    pad = (-(len(verts) * 3)) % 4
    return (struct.pack("<II", len(verts), len(tris)) + verts.tobytes()
            + colors.tobytes() + b"\0" * pad + tris.tobytes())


class WebFrontend:
    """Serve the live scene over HTTP; the same interface as SLAMFrontend."""

    def __init__(self, output: str, init_pose=None, cam_scale: float = 0.3,
                 save_rendering: bool = False, near: int = 0,
                 estimate_c2w_list=None, gt_c2w_list=None,
                 port: int = 8765, host: str = "127.0.0.1"):
        self.output = output
        self.cam_scale = cam_scale
        self.near = int(near)  # the trajectory starts after this frame
        if save_rendering:
            import warnings

            warnings.warn(
                "WebFrontend streams live geometry to the browser but has "
                "no offscreen rasterizer; --save_rendering is ignored; "
                "use the offline frontend for vis.mp4", stacklevel=2)
        self.gt_c2w_list = gt_c2w_list
        self._lock = threading.Lock()
        self._mesh_blob: Optional[bytes] = None
        self._mesh_version = -1
        self._est: List[List[float]] = []
        self._gt: List[List[float]] = []
        self._frustum: List[List[float]] = []
        self._idx = -1
        self.done = False
        self.renderer = None  # the "has a mesh yet" flag the replay loop reads

        frontend = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):  # quiet
                pass

            def do_GET(self):
                path = self.path.split("?")[0]
                if path == "/":
                    body = _PAGE.encode()
                    ctype = "text/html; charset=utf-8"
                elif path == "/state":
                    with frontend._lock:
                        body = json.dumps({
                            "idx": frontend._idx,
                            "mesh_version": frontend._mesh_version,
                            "est": frontend._est,
                            "gt": frontend._gt,
                            "frustum": frontend._frustum,
                            "done": frontend.done,
                        }).encode()
                    ctype = "application/json"
                elif path == "/mesh.bin":
                    with frontend._lock:
                        body = frontend._mesh_blob or b"\0" * 8
                    ctype = "application/octet-stream"
                else:
                    self.send_response(404)
                    self.end_headers()
                    return
                self.send_response(200)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.send_header("Cache-Control", "no-store")
                self.end_headers()
                self.wfile.write(body)

        # loopback by default: the scene is exposed on every interface only
        # when the caller asks (--host 0.0.0.0)
        self._server = ThreadingHTTPServer((host, port), Handler)
        self.port = self._server.server_address[1]
        self._thread = threading.Thread(target=self._server.serve_forever,
                                        daemon=True)
        self._thread.start()
        shown = "localhost" if host in ("127.0.0.1", "0.0.0.0") else host
        print(f"INFO: web viewer listening on http://{shown}:{self.port}/"
              + ("" if host == "127.0.0.1" else f" (bound to {host})"), flush=True)

    def update_mesh(self, mesh_path: str) -> None:
        from nice_slam_torch.utils.meshlib import read_ply

        blob = mesh_blob(*read_ply(mesh_path))
        with self._lock:
            self._mesh_blob = blob
            self._mesh_version += 1
        self.renderer = True

    def update_pose(self, idx: int, c2w: np.ndarray) -> None:
        if idx < self.near:
            return None
        c2w = np.asarray(c2w, np.float32)
        with self._lock:
            self._idx = int(idx)
            self._est.append([float(v) for v in c2w[:3, 3]])
            if self.gt_c2w_list is not None and idx < len(self.gt_c2w_list):
                self._gt.append([float(v) for v in
                                 np.asarray(self.gt_c2w_list[idx])[:3, 3]])
            self._frustum = _frustum_lines(c2w, self.cam_scale)
        return None

    def finalize_video(self, path: str, fps: int = 30) -> Optional[str]:
        self.done = True
        return None  # the viewer stays up; nothing to encode

    def close(self) -> None:
        self._server.shutdown()
        self._server.server_close()
