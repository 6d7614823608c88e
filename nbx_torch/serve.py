"""Live interactive viewer server (port of `nbx/serve.py`): the reference's
browser experience (orbit, drag-to-spawn, live GUI sliders) served from the
simulation host.

A stdlib HTTP server; a background thread steps the simulation and renders
each frame on the device, and the single-page client maps mouse gestures to
the reference's verbs:

    drag (add mode)   -> /spawn?sx0=..&sy0=..&sx1=..&sy1=..   (slingshot)
    drag (view mode)  -> /orbit?dyaw=..&dpitch=..             (orbit controls)
    wheel/middle-drag -> /orbit?zoom=..                       (dolly)
    GUI sliders       -> /set?G=..&fracture_threshold=..
    scenario buttons  -> /reset?scenario=galaxy|collision
    window resize     -> /resize?w=..&h=..
    HUD               -> /state  (bodies alive, energy, step count, errors)

The client reads /stream, a multipart/x-mixed-replace PNG push stream woken
by a frame Condition, and falls back to 10 Hz /frame.png polling. The HTTP
layer (`_PAGE`, `make_handler`) is the JAX package's, unchanged.

The frame loop dispatches frame k+1, then reads frame k back: each image is
converted to uint8 on the device and copied through `viewer.AsyncReadback`
(a pinned buffer and a CUDA event), so the readback and the PNG encoding
overlap the next frame. `BigLiveSim` reads its counters back the same way, a
frame late, as one stacked tensor: no frame waits on a `.item()`.

Deliberate difference from the JAX package: `BigLiveSim` sizes its collision
buckets for the scene and re-sizes them (`ops.collide.bucketed_layout_for`,
with RESIZE_BLOCK_SLACK headroom) on the frame after a late readback shows
n_overflow > 0. The JAX package
sizes them once per scene, and its 131,072-body cloud collapses until the
buckets overflow. /state's n_overflow is the last frame's count (not the
largest ever), beside n_resizes.

A frame that raises does not stop the server (the reference's behaviour):
/state shows its exception as `error` until the next good frame, and counts
it in `n_errors`, with the first one's text in `first_error`, both never
cleared.

Usage:
    python -m nbx_torch serve [--port 8000] [--big]
"""

from __future__ import annotations

import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlparse

import numpy as np
import torch

from nbx_torch.config import CUDA, SimConfig
from nbx_torch.interactive import Simulation
from nbx_torch.render.pipeline import FrameState, render_and_advance
from nbx_torch.render.splat import Camera
from nbx_torch.render.viewer import AsyncReadback, png_bytes, to_u8_device

_TUNABLE = {
    "G", "softening", "dt", "spawn_mass", "fracture_threshold",
    "min_fragment_mass", "merge_time", "heat_decay", "heat_to_glow",
    "restitution", "friction",
}
# Renderer-side live parameters (the GUI's Visuals folder), read by LiveSim,
# not SimConfig.
_VIEWER_TUNABLE = {"bloom_strength", "bloom_threshold", "exposure"}


class LiveSim:
    """Simulation and renderer stepped by a background thread on `device`
    (the card unless the caller asks for the CPU)."""

    def __init__(self, cfg: SimConfig | None = None, scenario: str = "galaxy", width: int = 640,
                 height: int = 360, fps: float = 30.0, device=CUDA):
        self.device = torch.device(device)
        self.sim = Simulation(cfg or SimConfig(), scenario=scenario, device=self.device)
        self.cam = Camera.default(self.device)
        self.frame_state = FrameState.create(self.sim.cfg.capacity, self.sim.cfg.trail_length,
                                             device=self.device)
        self._init_runtime(width, height, fps)

    def _init_runtime(self, width, height, fps):
        self.width, self.height = width, height
        self.lock = threading.Lock()
        self.min_frame_s = 1.0 / fps
        # Visuals sliders (the reference's defaults)
        self.bloom_strength = 1.2
        self.bloom_threshold = 0.3
        self.exposure = 1.5
        self.frame_png: bytes = b""
        self.frame_seq = 0  # bumps per encoded frame; /stream waits on it
        self.frame_cond = threading.Condition()
        self.step_count = 0
        self.paused = False
        self.error = None  # the last frame's exception, cleared by the next good frame
        self.n_errors = 0  # frames that raised, and the first one's exception: never cleared
        self.first_error = None
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._loop, daemon=True)

    def start(self):
        self._thread.start()
        return self

    def stop(self):
        self._stop.set()
        self._thread.join(timeout=5)

    def _advance_and_render(self) -> torch.Tensor:
        """One physics frame and one rendered image, uint8 on the device
        (BigLiveSim overrides it with the at-scale path)."""
        ev = self.sim.step(1)
        self.frame_state, img = render_and_advance(
            self.frame_state, self.sim.state, self.sim.cfg, ev, self.cam, width=self.width, height=self.height,
            exposure=self.exposure, bloom_strength=self.bloom_strength, bloom_threshold=self.bloom_threshold)
        return to_u8_device(img)

    def _publish(self, img: np.ndarray) -> None:
        # zlib level 1: latency matters more than bytes here
        self.frame_png = png_bytes(img, level=1)
        self.step_count += 1
        self.error = None
        with self.frame_cond:
            self.frame_seq += 1
            self.frame_cond.notify_all()

    def _loop(self):
        # one-frame pipeline: dispatch frame k+1, then read back and encode
        # frame k while the device computes k+1 (one frame of HUD latency)
        rb = AsyncReadback()
        while not self._stop.is_set():
            t0 = time.time()
            try:
                img = None
                with self.lock:
                    if not self.paused:
                        img = self._advance_and_render()
                ready = rb.push(img) if img is not None else rb.flush()
                if ready is not None:
                    self._publish(ready)
            except Exception as e:  # keep serving; surface in /state
                rb = AsyncReadback()
                self.error = f"{type(e).__name__}: {e}"
                self.n_errors += 1
                self.first_error = self.first_error or self.error
                time.sleep(0.5)
            dt = time.time() - t0
            if dt < self.min_frame_s:
                time.sleep(self.min_frame_s - dt)

    # -- verbs ---------------------------------------------------------------
    def spawn_screen(self, sx0, sy0, sx1, sy1):
        with self.lock:
            return self.sim.spawn_drag_screen(self.cam, sx0, sy0, sx1, sy1, self.width, self.height)

    def orbit(self, dyaw=0.0, dpitch=0.0, zoom=1.0, panx=0.0, pany=0.0):
        with self.lock:
            self.cam = self.cam.orbit(dyaw, dpitch, zoom)
            if panx or pany:
                self.cam = self.cam.pan(panx, pany)

    def set_params(self, **kw):
        with self.lock:
            for k in list(kw):
                if k in _VIEWER_TUNABLE:
                    setattr(self, k, float(kw.pop(k)))
            if kw:
                self.sim.set(**{k: float(v) for k, v in kw.items()})

    def reset(self, scenario: str):
        with self.lock:
            self.sim.reset(scenario)
            self.frame_state = FrameState.create(self.sim.cfg.capacity, self.sim.cfg.trail_length,
                                                 device=self.device)

    def resize(self, w: int, h: int):
        """Render at a new size from the next frame on (the reference's
        window-resize handler). The render state is world-space, so nothing
        is rebuilt. Bounded to 1920 x 1080."""
        w = max(64, min(int(w), 1920))
        h = max(36, min(int(h), 1080))
        with self.lock:
            self.width, self.height = w, h

    def stats(self) -> dict:
        with self.lock:
            d = self.sim.measure()
            cfg = self.sim.cfg
            return {
                "step": self.step_count,
                "width": self.width,
                "height": self.height,
                "alive": int(d.n_alive),
                "energy": float(d.kinetic + d.potential),
                "max_temp": float(d.max_temp),
                "G": float(cfg.G),
                "dt": float(cfg.dt),
                # slider state, so the GUI initialises from the server
                "params": {
                    "G": float(cfg.G),
                    "dt": float(cfg.dt),
                    "spawn_mass": float(cfg.spawn_mass),
                    "fracture_threshold": float(cfg.fracture_threshold),
                    "merge_time": float(cfg.merge_time),
                    "bloom_strength": self.bloom_strength,
                    "bloom_threshold": self.bloom_threshold,
                },
                "error": self.error,
                "n_errors": self.n_errors,
                "first_error": self.first_error,
            }


# A re-size happens while the cloud collapses: the tail bucket's window count
# keeps growing, and at bucketed_layout_for's default 1.3 the first frame on a
# re-sized 131,072-body layout could overflow again (1,018 bodies, NVIDIA H100
# 80GB HBM3 at 700 W, `chip_smoke.py` phase 31). Twice the occupied windows is
# the headroom `chip_smoke.py` phase 7 keeps between its re-sizes.
RESIZE_BLOCK_SLACK = 2.0


class BigLiveSim(LiveSim):
    """The at-scale live viewer: the occupancy-bucketed granular step
    (`collisions_scaled.granular_full_kdk_scan`, the collision kernel K2, PM
    gravity) and `render.pipeline.render_granular` behind the same HTTP verbs,
    131,072 bodies by default.

    Differences from LiveSim, inherent to scale (as in the JAX package):
      * spawn fills a dead slot (no FIFO eviction; a full state drops it);
      * the HUD energy is kinetic only;
      * scenarios: 'cloud' (the bench's uniform cloud) and 'disk' (the debris
        annulus).
    And from the JAX package's BigLiveSim: the buckets are re-sized after an
    overflow (module docstring).
    """

    COUNTERS = ("n_bounces", "n_merges", "n_fractures")

    def __init__(self, n: int = 131072, cfg: SimConfig | None = None, scenario: str = "cloud", width: int = 640,
                 height: int = 360, fps: float = 30.0, force_impl: str = "pm", pm_grid: int = 64,
                 n_cells: int = 40, band_cells: int = 12, steps_per_frame: int = 1, n_trails: int = 256,
                 device=CUDA):
        self.device = torch.device(device)
        self.n = n
        self.cfg = (cfg or SimConfig(G=0.5, dt=0.016, sub_steps=1, merge_time=0.25,
                                     fracture_threshold=8.0)).to(self.device)
        self.force_impl = force_impl
        self.pm_grid = pm_grid
        self.g_c = n_cells
        self.band = band_cells
        self.steps_per_frame = steps_per_frame
        self.n_trails = min(n_trails, n)
        self._load_scene(scenario)
        self._init_runtime(width, height, fps)

    def _load_scene(self, scenario: str):
        from nbx_torch.bench.granular import BOX, debris_disk, granular_cloud
        from nbx_torch.collisions_scaled import make_granular_state
        from nbx_torch.ops.collide import bucketed_layout_for
        from nbx_torch.render.pipeline import starfield_directions

        dev = self.device
        self.scenario = scenario
        self.box = BOX * (self.n / 131072.0) ** (1.0 / 3.0)
        if scenario == "disk":
            pos, vel, mass = debris_disk(self.n - 1)
            self.box = BOX
        else:
            pos, vel, mass = granular_cloud(self.n, box=self.box)
        self.state = make_granular_state(pos, vel, mass, seed=0, device=dev)
        self.buckets = bucketed_layout_for(pos, self.box, self.g_c, self.band)
        # the scene's Green's function, once (at one step a frame the scan
        # cannot amortise it)
        self.green_hat = None
        if self.force_impl == "pm":
            from nbx_torch.ops.pm import isolated_green_hat

            self.green_hat = isolated_green_hat(self.box, self.pm_grid, device=dev)
        self.trail_idx = torch.from_numpy(np.argsort(-np.asarray(mass), kind="stable")[: self.n_trails]).to(dev)
        self.frame_state = FrameState.create(self.n_trails, 40, device=dev)
        self.stars = starfield_directions(device=dev)
        c = 0.5 * self.box
        self.cam = Camera(eye=torch.tensor([c, c + 0.6 * self.box, c + 1.6 * self.box], dtype=torch.float32,
                                           device=dev),
                          target=torch.full((3,), c, dtype=torch.float32, device=dev),
                          up=torch.tensor([0.0, 1.0, 0.0], device=dev))
        self.counters = {k: 0 for k in self.COUNTERS}
        self.n_overflow = 0  # the last frame read back
        self.n_resizes = 0
        self._resize = False
        self._totals = AsyncReadback()
        self._pending_layout = 0  # the layout (n_resizes) of the frame in flight

    def _advance_and_render(self) -> torch.Tensor:
        from nbx_torch.collisions_scaled import granular_full_kdk_scan
        from nbx_torch.ops.collide import bucketed_layout_for
        from nbx_torch.render.pipeline import render_granular

        if self._resize:  # the last readback showed an overflow of the current layout
            self.buckets = bucketed_layout_for(self.state.pos, self.box, self.g_c, self.band,
                                               block_slack=RESIZE_BLOCK_SLACK)
            self.n_resizes += 1
            self._resize = False
        self.state, totals, ev = granular_full_kdk_scan(
            self.state, self.cfg, self.box, n_steps=self.steps_per_frame, n_cells=self.g_c,
            band_cells=self.band, buckets=self.buckets, force_impl=self.force_impl, pm_grid=self.pm_grid,
            log_events=True, green_hat=self.green_hat)
        self.frame_state, img = render_granular(
            self.frame_state, self.state, self.cfg, ev, self.cam, self.trail_idx, width=self.width,
            height=self.height, exposure=self.exposure, stars=self.stars, bloom_strength=self.bloom_strength,
            bloom_threshold=self.bloom_threshold)
        # the counters, one stacked tensor read back a frame late, with the
        # number of re-sizes before the frame that counted them
        vals = self._totals.push(torch.stack([totals[k] for k in (*self.COUNTERS, "n_overflow")]))
        layout, self._pending_layout = self._pending_layout, self.n_resizes
        if vals is not None:
            self._count(vals, layout)
        return to_u8_device(img)

    def _count(self, vals, layout: int) -> None:
        for k, v in zip(self.COUNTERS, vals):
            self.counters[k] += int(v)
        self.n_overflow = int(vals[-1])
        # re-size once per overflowing layout: a frame read back late may
        # have run on a layout that is already replaced
        self._resize = self.n_overflow > 0 and layout == self.n_resizes

    # -- verbs ----------------------------------------------------------
    def spawn_screen(self, sx0, sy0, sx1, sy1):
        from nbx_torch.render.splat import screen_to_plane

        with self.lock:
            p0, hit0 = screen_to_plane(self.cam, sx0, sy0, self.width, self.height, plane_y=0.5 * self.box)
            p1, hit1 = screen_to_plane(self.cam, sx1, sy1, self.width, self.height, plane_y=0.5 * self.box)
            if not (bool(hit0) and bool(hit1)):
                return 0, 0
            vel = -0.5 * (p1 - p0)  # the slingshot
            st = self.state
            dead = st.mass <= 0.0
            idx = int(dead.to(torch.int32).argmax())
            if not bool(dead[idx]):
                return 0, 0  # state full: the spawn is dropped, not evicted
            i = torch.tensor([idx], device=self.device)
            self.state = st.replace(
                pos=st.pos.index_copy(0, i, p0[None]), vel=st.vel.index_copy(0, i, vel[None]),
                mass=st.mass.index_fill(0, i, self.cfg.spawn_mass), mat=st.mat.index_fill(0, i, 0),
                temp=st.temp.index_fill(0, i, 0.0))
            return 1, 0

    def set_params(self, **kw):
        with self.lock:
            for k in list(kw):
                if k in _VIEWER_TUNABLE:
                    setattr(self, k, float(kw.pop(k)))
            if kw:
                self.cfg = self.cfg.replace(**{k: float(v) for k, v in kw.items()})

    def reset(self, scenario: str):
        with self.lock:
            self._load_scene(scenario if scenario in ("cloud", "disk") else "cloud")

    def stats(self) -> dict:
        with self.lock:
            st, cfg = self.state, self.cfg
            ke = float(0.5 * (st.mass * (st.vel * st.vel).sum(-1)).sum())
            return {
                "step": self.step_count,
                "width": self.width,
                "height": self.height,
                "alive": int((st.mass > 0).sum()),
                "energy": ke,  # kinetic only at scale
                "max_temp": float(st.temp.max()),
                "G": float(cfg.G),
                "dt": float(cfg.dt),
                "params": {
                    "G": float(cfg.G),
                    "dt": float(cfg.dt),
                    "spawn_mass": float(cfg.spawn_mass),
                    "fracture_threshold": float(cfg.fracture_threshold),
                    "merge_time": float(cfg.merge_time),
                    "bloom_strength": self.bloom_strength,
                    "bloom_threshold": self.bloom_threshold,
                },
                **self.counters,
                "n_overflow": self.n_overflow,
                "n_resizes": self.n_resizes,
                "error": self.error,
                "n_errors": self.n_errors,
                "first_error": self.first_error,
            }


_PAGE = """<!DOCTYPE html><html><head><meta charset="utf-8">
<title>nbx live</title><style>
body{margin:0;background:#000;color:#aaa;font-family:monospace;overflow:hidden}
#hud{position:fixed;top:8px;left:8px;pointer-events:none}
img{width:100vw;height:100vh;object-fit:contain;image-rendering:pixelated}
#ov{position:fixed;left:0;top:0;width:100vw;height:100vh;pointer-events:none}
#gui{position:fixed;top:8px;right:8px;width:230px;background:rgba(18,18,24,.88);
border:1px solid #333;border-radius:6px;font-size:12px;user-select:none}
#gui h3{margin:0;padding:5px 8px;background:#1d1d26;color:#ddd;cursor:pointer;
font-size:12px;border-bottom:1px solid #333}
.fold{padding:4px 8px 6px}.fold.closed{display:none}
.row{display:flex;align-items:center;margin:3px 0;gap:6px}
.row label{flex:0 0 86px;color:#9ab}
.row input[type=range]{flex:1;accent-color:#4a7dff;height:14px}
.row .val{flex:0 0 44px;text-align:right;color:#dde}
.btn{display:inline-block;margin:2px 3px 2px 0;padding:3px 10px;background:#2a2a38;
color:#cdd;border:1px solid #444;border-radius:4px;cursor:pointer}
.btn.on{background:#4a7dff;color:#fff;border-color:#4a7dff}
#instructions{position:fixed;left:8px;bottom:8px;max-width:380px;
background:rgba(18,18,24,.85);border:1px solid #333;border-radius:6px;
padding:8px 12px;font-size:12px;line-height:1.6;color:#9ab}
#instructions b{color:#dde}
#modepill{position:fixed;left:50%;top:10px;transform:translateX(-50%);
padding:3px 14px;border-radius:12px;background:rgba(74,125,255,.25);
border:1px solid #4a7dff;color:#cdf;font-size:12px;pointer-events:none}
</style></head><body>
<img id="v"><canvas id="ov"></canvas><div id="hud"></div>
<div id="modepill">VIEW MODE</div>
<div id="instructions"><b>nbx — realistic n-body fusion</b><br>
Left-drag: orbit &nbsp; Right/Shift-drag: pan &nbsp; Wheel / middle-drag:
dolly<br><b>A</b>: toggle add mode &mdash; in add mode, drag and release to
slingshot-spawn a body (drag back = velocity)<br>
Sliders retune physics live; scenario buttons reset. Click this panel to
hide.</div>
<div id="gui"></div>
<script>
let mode='view', drag=null, cur=null;
let W=__W__, H=__H__;
const v=document.getElementById('v'), hud=document.getElementById('hud'),
      ov=document.getElementById('ov'), gui=document.getElementById('gui'),
      pill=document.getElementById('modepill'),
      instr=document.getElementById('instructions');
instr.onclick=()=>instr.style.display='none';
// ---- control panel (the lil-gui folders, index.html:847-871) ----
const SLIDERS={
 Physics:[['G','G',0.1,5,0.01],['dt','dt',0.001,0.05,0.001],
          ['fracture_threshold','fracture',1,100,1],['merge_time','mergeTime',0.1,3,0.01]],
 Interaction:[['spawn_mass','spawnMass',1,5000,1]],
 Visuals:[['bloom_strength','bloomStr',0,3,0.01],['bloom_threshold','bloomThr',0,1,0.01]]};
const inputs={};
function folder(name, body){
  const h=document.createElement('h3'); h.textContent=name;
  const d=document.createElement('div'); d.className='fold';
  h.onclick=()=>d.classList.toggle('closed');
  gui.appendChild(h); gui.appendChild(d); body(d); }
function slider(d,[key,label,min,max,step]){
  const row=document.createElement('div'); row.className='row';
  row.innerHTML=`<label>${label}</label><input type=range min=${min} max=${max} step=${step}><span class=val></span>`;
  const inp=row.querySelector('input'), val=row.querySelector('.val');
  inp.oninput=()=>{val.textContent=(+inp.value).toPrecision(3);
    fetch(`/set?${key}=${inp.value}`);};
  inputs[key]=(x)=>{inp.value=x; val.textContent=(+x).toPrecision(3);};
  d.appendChild(row); }
function button(d,label,fn,id){
  const b=document.createElement('span'); b.className='btn'; if(id)b.id=id;
  b.textContent=label; b.onclick=fn; d.appendChild(b); return b; }
folder('Interaction',d=>{
  button(d,'View',()=>setMode('view'),'bView');
  button(d,'Add (a)',()=>setMode('add'),'bAdd');
  SLIDERS.Interaction.forEach(s=>slider(d,s));});
folder('Physics',d=>SLIDERS.Physics.forEach(s=>slider(d,s)));
folder('Visuals',d=>SLIDERS.Visuals.forEach(s=>slider(d,s)));
folder('Scenarios',d=>{
  button(d,'Galaxy',()=>fetch('/reset?scenario=galaxy'));
  button(d,'Collision',()=>fetch('/reset?scenario=collision'));});
function setMode(m){mode=m;
  document.getElementById('bView').classList.toggle('on',m==='view');
  document.getElementById('bAdd').classList.toggle('on',m==='add');
  pill.textContent=m==='add'?'ADD MODE — drag to spawn':'VIEW MODE';}
setMode('view');
addEventListener('keydown',e=>{if(e.key==='a'||e.key==='A')
  setMode(mode==='view'?'add':'view');});
// ---- frame stream (multipart push; poll fallback) + HUD + slider sync ----
let polling=null;
function startPoll(){if(polling)return;
 polling=setInterval(()=>{v.src='/frame.png?t='+Date.now();},100);}
v.onerror=()=>startPoll();
v.src='/stream';
// safety: if the stream shows nothing within 3s, fall back to polling
setTimeout(()=>{if(!v.naturalWidth)startPoll();},3000);
let synced=false;
setInterval(async()=>{const s=await(await fetch('/state')).json();
 hud.textContent=`step ${s.step}  bodies ${s.alive}  E ${s.energy.toFixed(1)}  G ${s.G}`
   +(s.error?`  ERR ${s.error}`:'');
 if(s.width){W=s.width;H=s.height;}
 if(!synced&&s.params){for(const k in s.params)if(inputs[k])inputs[k](s.params[k]);
   synced=true;}},500);
// ---- live resize (reference window-resize handler, L885-891) ----
let rszT=null;
function sendResize(){
 const r=Math.min(devicePixelRatio||1,1.5);
 fetch(`/resize?w=${Math.round(innerWidth*r)}&h=${Math.round(innerHeight*r)}`);}
addEventListener('resize',()=>{clearTimeout(rszT);rszT=setTimeout(sendResize,400);});
sendResize();
// ---- input: orbit drag / add-mode slingshot with preview line ----
function toFrame(e){const r=v.getBoundingClientRect();
 return [(e.clientX-r.left)/r.width*W,(e.clientY-r.top)/r.height*H];}
function drawPreview(){
 ov.width=innerWidth; ov.height=innerHeight;
 const c=ov.getContext('2d'); c.clearRect(0,0,ov.width,ov.height);
 if(!drag||!cur||mode!=='add')return;
 const r=v.getBoundingClientRect();
 const sx=x=>r.left+x/W*r.width, sy=y=>r.top+y/H*r.height;
 c.strokeStyle='#00ff00'; c.lineWidth=2;           /* green preview line */
 c.beginPath(); c.moveTo(sx(drag[0]),sy(drag[1]));
 c.lineTo(sx(cur[0]),sy(cur[1])); c.stroke();
 c.fillStyle='#00ff00';
 c.beginPath(); c.arc(sx(drag[0]),sy(drag[1]),3,0,7); c.fill();}
let panning=false,dollying=false;
v.addEventListener('contextmenu',e=>e.preventDefault());
v.addEventListener('mousedown',e=>{drag=toFrame(e);cur=drag;
 panning=(e.button===2||e.shiftKey);dollying=(e.button===1);
 e.preventDefault();});
addEventListener('mouseup',async e=>{if(!drag)return;const p=toFrame(e);
 if(mode==='add'&&!panning&&!dollying){await fetch(`/spawn?sx0=${drag[0]}&sy0=${drag[1]}&sx1=${p[0]}&sy1=${p[1]}`);}
 drag=null;cur=null;panning=false;dollying=false;drawPreview();});
// damped orbit/pan/dolly (the OrbitControls enableDamping feel, L717-722:
// left=rotate, MIDDLE=dolly, right=pan): drags feed a velocity that a rAF
// loop applies and decays
let vyaw=0,vpitch=0,vpx=0,vpy=0,vzoom=0;
addEventListener('mousemove',e=>{if(!drag)return;const p=toFrame(e);
 if(mode==='add'&&!panning&&!dollying){cur=p;drawPreview();return;}
 if(dollying){vzoom+=(p[1]-drag[1])*3e-3;}
 else if(panning){vpx+=-(p[0]-drag[0])*3e-4;vpy+=(p[1]-drag[1])*3e-4;}
 else{vyaw+=(p[0]-drag[0])*2e-3;vpitch+=(p[1]-drag[1])*2e-3;}
 drag=p;});
let orbitBusy=false;
async function damp(){
 if(!orbitBusy&&(Math.abs(vyaw)+Math.abs(vpitch)+Math.abs(vpx)+Math.abs(vpy)
    +Math.abs(vzoom)>1e-4)){
  orbitBusy=true;
  const q=`/orbit?dyaw=${vyaw}&dpitch=${vpitch}&panx=${vpx}&pany=${vpy}`
    +`&zoom=${Math.exp(vzoom)}`;
  vyaw*=0.82;vpitch*=0.82;vpx*=0.82;vpy*=0.82;vzoom*=0.82; /* damping */
  try{await fetch(q);}finally{orbitBusy=false;}}
 requestAnimationFrame(damp);}
requestAnimationFrame(damp);
addEventListener('wheel',e=>fetch(`/orbit?zoom=${Math.exp(e.deltaY*0.001)}`));
</script></body></html>"""


def make_handler(live: LiveSim):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):  # quiet
            pass

        def _send(self, code, body, ctype="application/json"):
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _stream(self):
            """multipart/x-mixed-replace PNG push stream: every encoded
            frame ships the moment LiveSim signals frame_cond — perceived
            rate == render rate (the 10 Hz poll quantization of round 2 is
            gone). One thread per streaming client (ThreadingHTTPServer)."""
            self.send_response(200)
            self.send_header(
                "Content-Type",
                "multipart/x-mixed-replace; boundary=nbxframe",
            )
            self.end_headers()
            seen = -1
            while True:
                with live.frame_cond:
                    live.frame_cond.wait_for(
                        lambda: live.frame_seq != seen, timeout=2.0
                    )
                    seen = live.frame_seq
                    buf = live.frame_png
                if not buf:
                    continue
                try:
                    self.wfile.write(
                        b"--nbxframe\r\nContent-Type: image/png\r\n"
                        + f"Content-Length: {len(buf)}\r\n\r\n".encode()
                    )
                    self.wfile.write(buf)
                    self.wfile.write(b"\r\n")
                except (BrokenPipeError, ConnectionResetError):
                    return  # client went away; thread exits

        def do_GET(self):
            try:
                self._route()
            except Exception as e:
                self._send(
                    400, json.dumps({"error": f"{type(e).__name__}: {e}"}).encode()
                )

        def _route(self):
            u = urlparse(self.path)
            q = {k: v[0] for k, v in parse_qs(u.query).items()}
            if u.path == "/":
                page = _PAGE.replace("__W__", str(live.width)).replace(
                    "__H__", str(live.height)
                )
                self._send(200, page.encode(), "text/html")
            elif u.path == "/frame.png":
                self._send(200, live.frame_png or b"", "image/png")
            elif u.path == "/stream":
                self._stream()
            elif u.path == "/resize":
                live.resize(int(float(q["w"])), int(float(q["h"])))
                self._send(200, json.dumps(
                    {"width": live.width, "height": live.height}
                ).encode())
            elif u.path == "/state":
                self._send(200, json.dumps(live.stats()).encode())
            elif u.path == "/spawn":
                spawned, evicted = live.spawn_screen(
                    float(q["sx0"]), float(q["sy0"]),
                    float(q["sx1"]), float(q["sy1"]),
                )
                self._send(200, json.dumps(
                    {"spawned": spawned, "evicted": evicted}
                ).encode())
            elif u.path == "/orbit":
                live.orbit(
                    float(q.get("dyaw", 0)), float(q.get("dpitch", 0)),
                    float(q.get("zoom", 1)),
                    float(q.get("panx", 0)), float(q.get("pany", 0)),
                )
                self._send(200, b"{}")
            elif u.path == "/set":
                params = {
                    k: float(v)
                    for k, v in q.items()
                    if k in _TUNABLE or k in _VIEWER_TUNABLE
                }
                live.set_params(**params)
                self._send(200, json.dumps({"set": params}).encode())
            elif u.path == "/reset":
                live.reset(q.get("scenario", "galaxy"))
                self._send(200, b"{}")
            else:
                self._send(404, b"{}")

    return Handler


def serve(port: int = 8000, cfg: SimConfig | None = None, scenario: str = "galaxy", block: bool = True,
          width: int = 640, height: int = 360, host: str = "127.0.0.1", big_n: int = 0):
    """Start the live viewer HTTP server; returns (httpd, live).

    big_n > 0 serves the at-scale granular path (BigLiveSim) with big_n
    bodies. Binds loopback only by default: the endpoints (/set, /reset,
    /spawn) change the simulation without authentication, so remote exposure
    is an explicit host="0.0.0.0". block=False returns with the server
    unstarted: the caller runs httpd.serve_forever (in a thread) and stops
    httpd and live."""
    if big_n:
        live = BigLiveSim(n=big_n, cfg=cfg, scenario=scenario if scenario in ("cloud", "disk") else "cloud",
                          width=width, height=height).start()
    else:
        live = LiveSim(cfg, scenario, width=width, height=height).start()
    httpd = ThreadingHTTPServer((host, port), make_handler(live))
    if block:
        print(f"nbx_torch live viewer on http://{host}:{port}" + (f" (big mode, N={big_n})" if big_n else ""),
              flush=True)
        try:
            httpd.serve_forever()
        finally:
            live.stop()
    return httpd, live
