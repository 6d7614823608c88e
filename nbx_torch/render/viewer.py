"""Host-side viewing (port of `nbx/render/viewer.py`): PNG frames, frame
sequences, a recorded trajectory and a standalone HTML player.

The frames are rendered on the device; `AsyncReadback` brings each one to the
host a frame late, through a pinned host buffer and a CUDA event, so the copy
overlaps the next frame's work and nothing waits on a frame still in flight.
PNG encoding is stdlib zlib: no imaging dependency.
"""

from __future__ import annotations

import json
import os
import struct
import zlib

import numpy as np
import torch


class AsyncReadback:
    """Double-buffered readback: push frame k+1's image (still being computed
    on the card), get frame k's back as numpy.

        rb = AsyncReadback()
        for ...:
            state, ev = sim.step(state, cfg)
            fr, img = render_and_advance(fr, state, cfg, ev, cam)
            ready = rb.push(img)      # the PREVIOUS frame, or None
            if ready is not None: write_png(..., ready)
        last = rb.flush()

    A CUDA image is copied into a pinned host buffer with non_blocking=True
    and a CUDA event recorded after the copy; the next push (or flush) waits
    on that event alone, which completes with the copy, not with the work
    queued after it, and returns a copy of the buffer. A CPU image is
    returned as it is.
    """

    def __init__(self):
        self._pending = None  # (host tensor, event or None)
        self._buf = None

    def push(self, device_img) -> np.ndarray | None:
        prev = self.flush()
        if isinstance(device_img, torch.Tensor) and device_img.is_cuda:
            if self._buf is None or self._buf.shape != device_img.shape or self._buf.dtype != device_img.dtype:
                self._buf = torch.empty(device_img.shape, dtype=device_img.dtype, pin_memory=True)
            self._buf.copy_(device_img, non_blocking=True)
            ev = torch.cuda.Event()
            ev.record()
            self._pending = (self._buf, ev)
        else:
            self._pending = (device_img, None)
        return prev

    def flush(self) -> np.ndarray | None:
        if self._pending is None:
            return None
        img, ev = self._pending
        self._pending = None
        if ev is not None:
            ev.synchronize()
            return img.numpy().copy()
        return img.numpy() if isinstance(img, torch.Tensor) else np.asarray(img)


def to_u8(img) -> np.ndarray:
    """[H, W, 3] float in [0, 1] -> uint8 (numpy; a tensor is read back)."""
    a = img.cpu().numpy() if isinstance(img, torch.Tensor) else np.asarray(img)
    return (np.clip(a, 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)


def to_u8_device(img: torch.Tensor) -> torch.Tensor:
    """to_u8 on the image's device (4x fewer bytes to read back)."""
    return (torch.clamp(img, 0.0, 1.0) * 255.0 + 0.5).to(torch.uint8)


def png_bytes(img, level: int = 6) -> bytes:
    """Encode [H, W, 3] (float in [0, 1] or uint8) as PNG bytes."""
    a = img.cpu().numpy() if isinstance(img, torch.Tensor) else np.asarray(img)
    a = a if a.dtype == np.uint8 else to_u8(a)
    h, w, _ = a.shape
    raw = b"".join(b"\x00" + a[i].tobytes() for i in range(h))

    def chunk(tag: bytes, data: bytes) -> bytes:
        c = struct.pack(">I", len(data)) + tag + data
        return c + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF)

    ihdr = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)
    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", ihdr) + chunk(b"IDAT", zlib.compress(raw, level))
            + chunk(b"IEND", b""))


def write_png(path: str, img, level: int = 6) -> None:
    """Write [H, W, 3] (float in [0, 1] or uint8) as a PNG file."""
    with open(path, "wb") as f:
        f.write(png_bytes(img, level))


def write_frames(dirpath: str, frames, prefix: str = "frame") -> list[str]:
    """Write a [T, H, W, 3] stack (or a sequence of frames) as numbered PNGs."""
    os.makedirs(dirpath, exist_ok=True)
    paths = []
    for t, img in enumerate(frames):
        p = os.path.join(dirpath, f"{prefix}_{t:05d}.png")
        write_png(p, img)
        paths.append(p)
    return paths


def _host(x):
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def record_trajectory(path: str, positions, radii, temps=None, mats=None, stride: int = 1,
                      max_bodies: int = 2000) -> None:
    """Dump a decimated trajectory ([T, N, 3] positions, [N] or [T, N]
    radii) as JSON for the HTML player."""
    pos = _host(positions)[::stride]
    t_len, n = pos.shape[0], pos.shape[1]
    keep = min(n, max_bodies)
    rad = _host(radii)
    rad = np.broadcast_to(rad, (t_len, n)) if rad.ndim == 1 else rad[::stride]
    data = {
        "pos": np.round(pos[:, :keep], 3).tolist(),
        "radius": np.round(rad[:, :keep], 3).tolist(),
        "temp": np.round(_host(temps)[::stride][:, :keep], 2).tolist() if temps is not None else None,
        "mat": _host(mats)[:keep].tolist() if mats is not None else None,
    }
    with open(path, "w") as f:
        json.dump(data, f)


_HTML_TEMPLATE = """<!DOCTYPE html>
<html><head><meta charset="utf-8"><title>nbx player</title>
<style>body{margin:0;background:#000;overflow:hidden;font-family:monospace}
#hud{position:fixed;top:8px;left:8px;color:#888}</style></head>
<body><canvas id="c"></canvas><div id="hud"></div>
<script>
const DATA = __DATA__;
const canvas = document.getElementById('c'), ctx = canvas.getContext('2d');
const hud = document.getElementById('hud');
let yaw = 0.6, pitch = 0.4, dist = 250, t = 0, playing = true;
function resize(){canvas.width=innerWidth;canvas.height=innerHeight;}
addEventListener('resize', resize); resize();
let drag=null;
canvas.addEventListener('mousedown',e=>drag=[e.clientX,e.clientY]);
addEventListener('mouseup',()=>drag=null);
addEventListener('mousemove',e=>{if(drag){yaw+=(e.clientX-drag[0])*0.005;
pitch+=(e.clientY-drag[1])*0.005;drag=[e.clientX,e.clientY];}});
addEventListener('wheel',e=>{dist*=Math.exp(e.deltaY*0.001);});
addEventListener('keydown',e=>{if(e.key===' ')playing=!playing;});
function colorOf(temp, mat){
  const base = [[0.35,0.25,0.18],[0.5,0.5,0.6],[0.5,0.7,0.9]][mat||0];
  const h = Math.min((temp||0)/50, 1);
  const r = base[0]*(1-0.7*h)+1.0*0.7*h, g = base[1]*(1-0.7*h)+0.3*0.7*h,
        b = base[2]*(1-0.7*h)+0.1*0.7*h;
  return `rgb(${r*255|0},${g*255|0},${b*255|0})`;
}
function frame(){
  const pos = DATA.pos[t|0], rad = DATA.radius[t|0];
  const temp = DATA.temp ? DATA.temp[t|0] : null;
  const cy=Math.cos(yaw), sy=Math.sin(yaw), cp=Math.cos(pitch), sp=Math.sin(pitch);
  const f = canvas.height/2/Math.tan(22.5*Math.PI/180);
  ctx.fillStyle='rgba(0,0,0,0.35)';ctx.fillRect(0,0,canvas.width,canvas.height);
  const pts=[];
  for(let i=0;i<pos.length;i++){
    const [x,y,z]=pos[i];
    let X=cy*x+sy*z, Z=-sy*x+cy*z, Y=cp*y-sp*Z; Z=sp*y+cp*Z+dist;
    if(Z<1) continue;
    pts.push([canvas.width/2+f*X/Z, canvas.height/2-f*Y/Z,
              Math.max(f*rad[i]/Z,0.7), Z, i]);
  }
  pts.sort((a,b)=>b[3]-a[3]);
  for(const [px,py,pr,_,i] of pts){
    ctx.fillStyle=colorOf(temp?temp[i]:0, DATA.mat?DATA.mat[i]:0);
    ctx.beginPath();ctx.arc(px,py,pr,0,7);ctx.fill();
  }
  hud.textContent=`frame ${t|0}/${DATA.pos.length-1}  bodies ${pos.length}  [space]=pause  drag=orbit  wheel=zoom`;
  if(playing) t=(t+0.5)%DATA.pos.length;
  requestAnimationFrame(frame);
}
frame();
</script></body></html>
"""


def write_html_player(path: str, trajectory_json_path: str) -> None:
    """Emit a self-contained HTML player embedding the recorded trajectory
    (orbit, zoom, pause)."""
    with open(trajectory_json_path) as f:
        data = f.read()
    with open(path, "w") as f:
        f.write(_HTML_TEMPLATE.replace("__DATA__", data))
