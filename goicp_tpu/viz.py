"""Visualization artifacts — the headless replacement for the OpenGL window.

The reference renders model=blue, data=red, in-progress=white point clouds
live (``src/kernel.cu:114-118``, ``src/window.cpp:182-227``).  A run here is
headless; the same information is written as colored PLY snapshots that any
viewer (MeshLab/CloudCompare/Open3D) displays, plus an optional pose
trajectory recorded from solver progress snapshots.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from goicp_tpu.core.progress import ProgressBus, SolverState
from goicp_tpu.io.ply import write_ply

# ≙ the reference's color assignment (kernel.cu:114-118)
COLOR_MODEL = np.array([64, 96, 255], np.uint8)    # target / model: blue
COLOR_DATA = np.array([255, 64, 64], np.uint8)     # registered source: red
COLOR_CURRENT = np.array([240, 240, 240], np.uint8)  # in-progress pose: white


def write_registration_ply(
    path: str,
    target: np.ndarray,
    source: np.ndarray,
    R: np.ndarray,
    t: np.ndarray,
    cur_R: Optional[np.ndarray] = None,
    cur_t: Optional[np.ndarray] = None,
):
    """Write target + transformed source (+ optional in-progress pose)."""
    target = np.asarray(target, np.float32)
    source = np.asarray(source, np.float32)
    moved = source @ np.asarray(R, np.float32).T + np.asarray(t, np.float32)
    clouds = [target, moved]
    colors = [
        np.tile(COLOR_MODEL, (target.shape[0], 1)),
        np.tile(COLOR_DATA, (moved.shape[0], 1)),
    ]
    if cur_R is not None:
        cur = source @ np.asarray(cur_R, np.float32).T + np.asarray(
            cur_t, np.float32
        )
        clouds.append(cur)
        colors.append(np.tile(COLOR_CURRENT, (cur.shape[0], 1)))
    write_ply(
        path,
        np.concatenate(clouds),
        np.concatenate(colors),
        comment="goicp_tpu registration (blue=model red=data white=current)",
    )


def render_png(
    path: str,
    target: np.ndarray,
    source: np.ndarray,
    R: np.ndarray,
    t: np.ndarray,
    phi: float = 0.4,
    theta: float = 0.0,
    max_points: int = 20000,
):
    """Static orthographic snapshot (matplotlib) — the headless stand-in for
    the reference's GL window (`window.cpp:182-227`); ``phi``/``theta`` match
    the TOML ``[visualization]`` camera angles (`common.cpp:60-66`)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    target = np.asarray(target, np.float32)
    moved = np.asarray(source, np.float32) @ np.asarray(R, np.float32).T + np.asarray(
        t, np.float32
    )

    def thin(c):
        if c.shape[0] > max_points:
            return c[:: c.shape[0] // max_points + 1]
        return c

    cp, ct = np.cos(phi), np.cos(theta)
    sp, st = np.sin(phi), np.sin(theta)
    Ry = np.array([[ct, 0, st], [0, 1, 0], [-st, 0, ct]], np.float32)
    Rx = np.array([[1, 0, 0], [0, cp, -sp], [0, sp, cp]], np.float32)
    cam = Rx @ Ry
    fig, ax = plt.subplots(figsize=(8, 6), dpi=110)
    for cloud, color, label, size in (
        (thin(target), "#4060ff", "model", 2.0),
        (thin(moved), "#ff4040", "registered data", 2.0),
    ):
        p = cloud @ cam.T
        ax.scatter(p[:, 0], p[:, 1], s=size, c=color, label=label, linewidths=0)
    ax.set_aspect("equal")
    ax.axis("off")
    ax.legend(loc="upper right", frameon=False)
    fig.savefig(path, bbox_inches="tight")
    plt.close(fig)


class LiveSnapshotter:
    """Periodic registration snapshots while the solver runs — the headless
    form of the reference's live render loop, which draws the incumbent
    (red) and currently-explored (white) poses every frame
    (``goicp_kernel.cu:152-206``, ``kernel.cu:114-118``).

    Subscribes to the :class:`ProgressBus`; at most one snapshot per
    ``every_s`` seconds of wall time (the render thread's poll cadence,
    decoupled from round rate) it writes ``snap_rNNNNN.ply`` — model blue,
    incumbent red, current white — into ``directory``, plus an optional PNG.
    Writing happens on the host between rounds; the device pipeline never
    blocks on it.
    """

    def __init__(
        self,
        bus: ProgressBus,
        directory: str,
        target: np.ndarray,
        source: np.ndarray,
        every_s: float = 2.0,
        png: bool = False,
        html: bool = True,
        max_snapshots: int = 200,
    ):
        import os
        import time

        self._os, self._time = os, time
        self.dir = directory
        self.target = np.asarray(target, np.float32)
        self.source = np.asarray(source, np.float32)
        self.every_s = every_s
        self.png = png
        self.html = html
        self.max_snapshots = max_snapshots
        self.paths: list[str] = []
        self.states: list[SolverState] = []
        self._last = None  # first publish always fires (perf_counter() is
                           # seconds since BOOT — a 0.0 sentinel silently
                           # throttles the first snapshot on a machine with
                           # uptime < every_s)
        bus.subscribe(self._on_state)

    def _on_state(self, s: SolverState):
        self.states.append(s)   # full trajectory for the live replay
        now = self._time.perf_counter()
        # the terminal state ALWAYS writes (throttle and snapshot cap do not
        # apply): live.html must drop its reload tag and show the final pose
        if not s.finished and (
            (self._last is not None and now - self._last < self.every_s)
            or len(self.paths) >= self.max_snapshots
        ):
            return
        self._last = now
        self._os.makedirs(self.dir, exist_ok=True)
        path = self._os.path.join(self.dir, f"snap_r{s.round:05d}.ply")
        write_registration_ply(
            path, self.target, self.source, s.opt_R, s.opt_t,
            cur_R=None if s.finished else s.cur_R,
            cur_t=None if s.finished else s.cur_t,
        )
        self.paths.append(path)
        if self.html:
            # a LIVE view while the solver runs: live.html re-renders the
            # trajectory so far and auto-reloads itself (meta refresh) until
            # the final state drops the tag, leaving the interactive replay —
            # the headless equivalent of the reference's window updating per
            # frame (goicp_kernel.cu:152-206)
            render_html(
                self._os.path.join(self.dir, "live.html"),
                self.target, self.source, self.states,
                refresh_s=0.0 if s.finished else max(self.every_s, 1.0),
            )
        if self.png:
            try:
                render_png(
                    self._os.path.splitext(path)[0] + ".png",
                    self.target, self.source, s.opt_R, s.opt_t,
                )
            except Exception:   # matplotlib optional
                pass


class TrajectoryRecorder:
    """Subscribes to solver progress; keeps the pose/error trajectory
    (the headless counterpart of watching the white cloud converge)."""

    def __init__(self, bus: ProgressBus):
        self.states: list[SolverState] = []
        bus.subscribe(self.states.append)

    def dump_csv(self, path: str):
        with open(path, "w") as f:
            f.write("round,best_sse,gap,rot_nodes,trans_nodes\n")
            for s in self.states:
                f.write(
                    f"{s.round},{s.best_sse!r},{s.gap!r},{s.rot_nodes},{s.trans_nodes}\n"
                )


_HTML_TEMPLATE = """<!DOCTYPE html>
<html><head><meta charset="utf-8"><title>goicp_tpu — registration replay</title>
<style>
  body { margin:0; background:#101014; color:#ddd;
         font:13px/1.4 system-ui, sans-serif; }
  #hud { position:fixed; top:0; left:0; right:0; padding:8px 12px;
         display:flex; gap:12px; align-items:center;
         background:rgba(16,16,20,.85); }
  #hud input[type=range] { flex:1; }
  button { background:#26262e; color:#ddd; border:1px solid #444;
           border-radius:4px; padding:2px 10px; cursor:pointer; }
  canvas { display:block; }
  .sw { display:inline-block; width:10px; height:10px; border-radius:2px;
        margin-right:4px; vertical-align:-1px; }
</style></head><body>
<div id="hud">
  <button id="play">&#9654;</button>
  <input id="round" type="range" min="0" max="0" value="0">
  <span id="label"></span>
  <span><span class="sw" style="background:#4060ff"></span>model</span>
  <span><span class="sw" style="background:#ff4040"></span>incumbent</span>
  <label><input id="showcur" type="checkbox" checked>
    <span class="sw" style="background:#eee"></span>explored</label>
</div>
<canvas id="c"></canvas>
<script>
const DATA = /*DATA*/;
const canvas = document.getElementById("c"), ctx = canvas.getContext("2d");
const slider = document.getElementById("round"),
      label = document.getElementById("label"),
      playBtn = document.getElementById("play"),
      showCur = document.getElementById("showcur");
let yaw = DATA.theta, pitch = DATA.phi, zoom = 1.0, drag = null,
    playing = null, spin = DATA.spin;
slider.max = Math.max(DATA.traj.length - 1, 0);
slider.value = slider.max;
function resize() {
  canvas.width = innerWidth; canvas.height = innerHeight;
  draw();
}
addEventListener("resize", resize);
canvas.addEventListener("mousedown", e => { spin = false;
                                            drag = [e.clientX, e.clientY]; });
addEventListener("mouseup", () => drag = null);
addEventListener("mousemove", e => {
  if (!drag) return;
  yaw += (e.clientX - drag[0]) * 0.008;
  pitch += (e.clientY - drag[1]) * 0.008;
  pitch = Math.max(-1.55, Math.min(1.55, pitch));
  drag = [e.clientX, e.clientY]; draw();
});
canvas.addEventListener("wheel", e => {
  e.preventDefault();
  zoom *= Math.exp(-e.deltaY * 0.001); draw();
}, {passive: false});
slider.addEventListener("input", draw);
showCur.addEventListener("change", draw);
playBtn.addEventListener("click", () => {
  if (playing) { clearInterval(playing); playing = null;
                 playBtn.innerHTML = "&#9654;"; return; }
  if (+slider.value >= +slider.max) slider.value = 0;
  playBtn.innerHTML = "&#9646;&#9646;";
  playing = setInterval(() => {
    slider.value = +slider.value + 1; draw();
    if (+slider.value >= +slider.max) {
      clearInterval(playing); playing = null; playBtn.innerHTML = "&#9654;";
    }
  }, 60);
});
function apply(P, R, t) {
  const out = new Float32Array(P.length);
  for (let i = 0; i < P.length; i += 3) {
    const x = P[i], y = P[i+1], z = P[i+2];
    out[i]   = R[0]*x + R[1]*y + R[2]*z + t[0];
    out[i+1] = R[3]*x + R[4]*y + R[5]*z + t[1];
    out[i+2] = R[6]*x + R[7]*y + R[8]*z + t[2];
  }
  return out;
}
function drawCloud(P, color, s) {
  const cy = Math.cos(yaw), sy = Math.sin(yaw);
  const cp = Math.cos(pitch), sp = Math.sin(pitch);
  const cx = canvas.width / 2, cz = canvas.height / 2 + 14;
  ctx.fillStyle = color;
  for (let i = 0; i < P.length; i += 3) {
    const x0 = P[i] - DATA.center[0], y0 = P[i+1] - DATA.center[1],
          z0 = P[i+2] - DATA.center[2];
    const x1 = cy*x0 + sy*z0, z1 = -sy*x0 + cy*z0;
    const y2 = cp*y0 - sp*z1;
    ctx.fillRect(cx + x1*s, cz - y2*s, 2, 2);
  }
}
function draw() {
  ctx.fillStyle = "#101014";
  ctx.fillRect(0, 0, canvas.width, canvas.height);
  const s = zoom * Math.min(canvas.width, canvas.height) * 0.45 / DATA.radius;
  const k = Math.min(+slider.value, DATA.traj.length - 1);
  drawCloud(DATA.target, "#4060ff", s);
  if (k >= 0) {
    const st = DATA.traj[k];
    if (showCur.checked && k < DATA.traj.length - 1)
      drawCloud(apply(DATA.source, st.cR, st.ct), "#e8e8e8", s);
    drawCloud(apply(DATA.source, st.R, st.t), "#ff4040", s);
    label.textContent = "round " + st.round + "  best_sse " +
      st.sse.toExponential(3) + "  gap " + st.gap.toExponential(2) +
      "  nodes " + st.nodes;
  } else {
    label.textContent = "no trajectory recorded";
  }
}
resize();
// spin_after_finish (reference [visualization] config): auto-orbit until
// the user grabs the view
(function spinLoop() {
  if (spin) { yaw += 0.01; draw(); }
  requestAnimationFrame(spinLoop);
})();
</script></body></html>
"""


def render_html(
    path: str,
    target: np.ndarray,
    source: np.ndarray,
    states: list,
    max_points: int = 4000,
    max_states: int = 400,
    phi: float = 0.35,
    theta: float = 0.6,
    spin: bool = False,
    refresh_s: float = 0.0,
):
    """Self-contained interactive HTML replay of the solve — the headless
    framework's answer to the reference's live GL window
    (``window.cpp:182-227``, colors ≙ ``kernel.cu:114-118``): orbit/zoom
    with the mouse, scrub or play the BnB trajectory (incumbent red,
    currently-explored white, model blue).  No dependencies; clouds are
    deterministically thinned to ``max_points`` and the trajectory strided
    to ``max_states`` so the file stays a few MB."""
    import json

    def thin(c):
        c = np.asarray(c, np.float32)
        if c.shape[0] > max_points:
            c = c[:: c.shape[0] // max_points + 1]
        return c

    tgt = thin(target)
    src = thin(source)
    if len(states) > max_states:
        stride = len(states) // max_states + 1
        last = states[-1]
        states = states[::stride]
        if states[-1] is not last:
            states = states + [last]
    both = np.concatenate([tgt, src]) if src.size else tgt
    center = both.mean(0)
    radius = float(np.linalg.norm(both - center, axis=1).max() or 1.0)

    def f(x):
        return [round(float(v), 6) for v in np.asarray(x, np.float64).ravel()]

    data = {
        "target": f(tgt),
        "source": f(src),
        "center": f(center),
        "radius": round(radius, 6),
        # ≙ the reference's [visualization] camera config (common.cpp:60-66)
        "phi": round(float(phi), 4),
        "theta": round(float(theta), 4),
        "spin": bool(spin),
        "traj": [
            {
                "round": int(s.round),
                "sse": float(s.best_sse),
                "gap": float(max(s.gap, 0.0)) if np.isfinite(s.gap) else 0.0,
                "nodes": int(s.rot_nodes),
                "R": f(s.opt_R), "t": f(s.opt_t),
                "cR": f(s.cur_R), "ct": f(s.cur_t),
            }
            for s in states
        ],
    }
    html = _HTML_TEMPLATE.replace(
        "/*DATA*/", json.dumps(data, separators=(",", ":"))
    )
    if refresh_s > 0:
        # live mode: the page reloads itself while the solver keeps writing
        # newer trajectories to the same file (LiveSnapshotter)
        html = html.replace(
            "<meta charset=\"utf-8\">",
            f"<meta charset=\"utf-8\">"
            f"<meta http-equiv=\"refresh\" content=\"{refresh_s:g}\">",
        )
    tmp = path + ".tmp"
    with open(tmp, "w") as fp:
        fp.write(html)
    import os as _os

    _os.replace(tmp, path)  # atomic: a reloading browser never sees a torn file
