"""Live trajectory/overlay viewer — rso's *live* GUI.

The reference runs a second thread with an MRPT 3D window that shows, while
the pipeline runs: the left/right images with feature marks, L-R pairing
rectangles, inter-frame tracking lines, and the integrated 3D camera path,
plus a key handler that can pause/step/quit the processing loop
(gui_thread.cpp:76-325, demo-main.cpp:256-284).

A remote accelerator host has no display, so the live window here is a tiny
self-contained HTTP server on a background thread: a browser (or curl)
polls JSON state at ~5 Hz and renders the 3D path on a canvas with
drag-to-rotate, the latest overlay frame as JPEG, and Pause/Step/Quit
buttons that feed the same control object the TTY key handler uses.  The
processing loop's only cost is `publish()` — a pointer swap under a lock;
all encoding happens lazily on the GUI thread when a client actually asks,
mirroring the reference's two-thread split where the GUI thread copies
state out of the engine between frames.

No external assets (zero-egress environment): the page is one inline HTML
string, vanilla JS, no CDN.
"""
from __future__ import annotations

import json
import secrets
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np


class RemoteControl:
    """Command queue bridging HTTP /control posts into the demo's key loop.

    Same verbs as the reference GUI key handler (demo-main.cpp:256-284):
    'p' pause/resume toggle, 's' single-step, 'q' quit.  The demo's
    _KeyControl polls `pop()` alongside stdin so TTY keys and browser
    buttons are interchangeable.
    """

    def __init__(self):
        self._lock = threading.Lock()
        self._cmds: list[str] = []

    def push(self, cmd: str):
        if cmd in ("p", "s", "q"):
            with self._lock:
                self._cmds.append(cmd)

    def pop(self) -> str | None:
        with self._lock:
            return self._cmds.pop(0) if self._cmds else None


def overlay_from_state(left_img: np.ndarray, right_img: np.ndarray,
                       state) -> np.ndarray:
    """Octave-0 feature/pairing overlay from the engine state's just-
    processed frame view (state.prev) — the marks the reference GUI draws
    (gui_thread.cpp:178-262: feature circles + L-R pairing lines).  Pulls
    four small [K] arrays to the host; call off the hot path.
    """
    from rso.metrics.viz import draw_overlay

    oc = state.prev.octaves[0]
    xy_l = np.asarray(oc.left.xy)
    xy_r = np.asarray(oc.right.xy)
    v_l = np.asarray(oc.left.valid)
    v_r = np.asarray(oc.right.valid)
    ridx = np.asarray(oc.matches.ridx)
    m_v = np.asarray(oc.matches.valid)
    pairs = [(xy_l[i], xy_r[ridx[i]]) for i in np.nonzero(m_v)[0][:200]]
    return draw_overlay(np.asarray(left_img, np.uint8),
                        np.asarray(right_img, np.uint8),
                        xy_l[v_l], xy_r[v_r], pairs)


class LiveViewer:
    """Background HTTP live view.  start() binds (port=0 picks a free one),
    publish() is called from the processing loop, stop() shuts the server.
    """

    def __init__(self, port: int = 0, control: RemoteControl | None = None):
        self.port = port
        self.control = control
        # /control auth: the 127.0.0.1 bind excludes remote hosts but not
        # other local users/processes on a shared machine — without a token
        # any local peer could pause or quit a long run.  The token is
        # embedded in the served page (same-origin JS sees it) and printed
        # by the CLI for curl users.
        self.token = secrets.token_urlsafe(12)
        self._lock = threading.Lock()
        self._positions: list[list[float]] = []
        self._gt_positions: list[list[float]] | None = None
        self._latest: dict = {"frame": -1}
        self._canvas: np.ndarray | None = None
        self._server: ThreadingHTTPServer | None = None
        self._thread: threading.Thread | None = None

    # ---- producer side (processing loop) ---------------------------------
    def publish(self, frame_idx: int, pose_wc: np.ndarray, valid: bool,
                counters: dict | None = None,
                canvas: np.ndarray | None = None):
        """Record the newest frame state.  O(1); no encoding here."""
        with self._lock:
            self._positions.append(
                [float(x) for x in np.asarray(pose_wc)[:3, 3]])
            self._latest = {"frame": int(frame_idx), "valid": bool(valid),
                            **{k: (float(v) if isinstance(v, (int, float,
                                                             np.number))
                                   else v)
                               for k, v in (counters or {}).items()}}
            if canvas is not None:
                self._canvas = canvas

    def set_ground_truth(self, gt_poses: np.ndarray):
        with self._lock:
            self._gt_positions = [
                [float(x) for x in p] for p in np.asarray(gt_poses)[:, :3, 3]]

    # ---- server side ------------------------------------------------------
    def _state_json(self, since: int) -> bytes:
        with self._lock:
            out = {"latest": self._latest,
                   "n": len(self._positions),
                   "since": since,
                   "positions": self._positions[since:],
                   "gt": self._gt_positions if since == 0 else None}
        return json.dumps(out).encode()

    def _frame_jpeg(self) -> bytes | None:
        with self._lock:
            canvas = self._canvas
        if canvas is None:
            return None
        import cv2

        ok, buf = cv2.imencode(".jpg", canvas,
                               [int(cv2.IMWRITE_JPEG_QUALITY), 80])
        return buf.tobytes() if ok else None

    def start(self) -> int:
        viewer = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):  # keep the demo's stderr clean
                pass

            def _send(self, code: int, ctype: str, body: bytes):
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                path, _, query = self.path.partition("?")
                if path == "/":
                    self._send(200, "text/html",
                               _PAGE.replace(b"%%TOKEN%%",
                                             viewer.token.encode()))
                elif path == "/state":
                    since = 0
                    for kv in query.split("&"):
                        if kv.startswith("since="):
                            try:
                                since = max(0, int(kv[6:]))
                            except ValueError:
                                pass
                    self._send(200, "application/json",
                               viewer._state_json(since))
                elif path == "/frame.jpg":
                    jpg = viewer._frame_jpeg()
                    if jpg is None:
                        self._send(404, "text/plain", b"no frame yet")
                    else:
                        self._send(200, "image/jpeg", jpg)
                else:
                    self._send(404, "text/plain", b"not found")

            def do_POST(self):
                path, _, query = self.path.partition("?")
                if path == "/control":
                    n = int(self.headers.get("Content-Length", 0) or 0)
                    cmd = self.rfile.read(n).decode(errors="replace").strip()
                    tok = self.headers.get("X-RSO-Token", "")
                    for kv in query.split("&"):
                        if kv.startswith("t="):
                            tok = kv[2:]
                    if not secrets.compare_digest(tok, viewer.token):
                        self._send(403, "text/plain", b"bad token")
                    elif viewer.control is not None and cmd in ("p", "s", "q"):
                        viewer.control.push(cmd)
                        self._send(200, "text/plain", b"ok")
                    else:
                        self._send(400, "text/plain", b"bad cmd")
                else:
                    self._send(404, "text/plain", b"not found")

        self._server = ThreadingHTTPServer(("127.0.0.1", self.port), Handler)
        self.port = self._server.server_address[1]
        self._thread = threading.Thread(target=self._server.serve_forever,
                                        daemon=True)
        self._thread.start()
        return self.port

    def stop(self):
        if self._server is not None:
            self._server.shutdown()
            self._server.server_close()
            self._server = None


_PAGE = b"""<!doctype html><html><head><title>rso live</title><style>
body{font-family:system-ui,sans-serif;margin:12px;background:#111;color:#ddd}
canvas{background:#181818;border:1px solid #333;touch-action:none}
#stats{font-size:13px;white-space:pre;margin:6px 0}
button{margin-right:6px;background:#2a2a2a;color:#ddd;border:1px solid #555;
padding:4px 10px;cursor:pointer} img{border:1px solid #333;max-width:760px}
</style></head><body>
<h3 style="margin:4px 0">rso live view</h3>
<div><button onclick="ctl('p')">pause/resume</button>
<button onclick="ctl('s')">step</button>
<button onclick="ctl('q')">quit</button>
<span style="font-size:12px;color:#888">drag = rotate, wheel = zoom</span></div>
<div id="stats">waiting for frames...</div>
<div style="display:flex;gap:12px;flex-wrap:wrap">
<canvas id="c" width="560" height="560"></canvas>
<img id="im" src="/frame.jpg" onerror="this.style.display='none'"
 onload="this.style.display=''"></div>
<script>
let pts=[],gt=null,n=0,az=-0.7,el=0.5,zoom=1,latest={};
function ctl(c){fetch('/control?t=%%TOKEN%%',{method:'POST',body:c});}
async function poll(){
 try{const r=await fetch('/state?since='+n);const s=await r.json();
  if(s.since===0){pts=[];}
  pts.push(...s.positions);n=s.n;latest=s.latest;if(s.gt)gt=s.gt;
  document.getElementById('stats').textContent=
   Object.entries(latest).map(([k,v])=>k+': '+
     (typeof v==='number'?v.toFixed(3).replace(/\\.000$/,''):v)).join('  ');
  const im=document.getElementById('im');
  im.src='/frame.jpg?'+Date.now();
  draw();}catch(e){}
 setTimeout(poll,200);}
function proj(p,cx,cy,s){
 const ca=Math.cos(az),sa=Math.sin(az),ce=Math.cos(el),se=Math.sin(el);
 const x=p[0]*ca+p[2]*sa, z=-p[0]*sa+p[2]*ca;
 const y=p[1]*ce-z*se;
 return [cx+x*s, cy-y*s];}
function draw(){
 const c=document.getElementById('c'),g=c.getContext('2d');
 g.clearRect(0,0,c.width,c.height);
 const all=gt?pts.concat(gt):pts; if(!all.length)return;
 let lo=[1/0,1/0,1/0],hi=[-1/0,-1/0,-1/0];
 for(const p of all)for(let i=0;i<3;i++){lo[i]=Math.min(lo[i],p[i]);
  hi[i]=Math.max(hi[i],p[i]);}
 const span=Math.max(hi[0]-lo[0],hi[1]-lo[1],hi[2]-lo[2],1e-6);
 const s=0.42*c.width/span*zoom,cx=c.width/2,cy=c.height/2;
 const mid=[(lo[0]+hi[0])/2,(lo[1]+hi[1])/2,(lo[2]+hi[2])/2];
 const ctr=p=>[p[0]-mid[0],p[1]-mid[1],p[2]-mid[2]];
 const line=(arr,color)=>{g.strokeStyle=color;g.lineWidth=2;g.beginPath();
  arr.forEach((p,i)=>{const q=proj(ctr(p),cx,cy,s);
   i?g.lineTo(q[0],q[1]):g.moveTo(q[0],q[1]);});g.stroke();};
 // axis triad at the origin of the centered frame
 g.lineWidth=1;
 [[1,0,0,'#a33'],[0,1,0,'#3a3'],[0,0,1,'#36c']].forEach(a=>{
  g.strokeStyle=a[3];g.beginPath();
  const o=proj([0,0,0],cx,cy,s),e=proj([a[0],a[1],a[2]].map(
   v=>v*span*0.12),cx,cy,s);
  g.moveTo(o[0],o[1]);g.lineTo(e[0],e[1]);g.stroke();});
 if(gt)line(gt,'#777');
 if(pts.length){
  line(pts,'#4da3ff');
  const last=proj(ctr(pts[pts.length-1]),cx,cy,s);
  g.fillStyle='#ffd24d';g.beginPath();
  g.arc(last[0],last[1],4,0,7);g.fill();}}
let drag=null;
const cv=document.getElementById('c');
cv.addEventListener('pointerdown',e=>{drag=[e.clientX,e.clientY];});
window.addEventListener('pointerup',()=>{drag=null;});
window.addEventListener('pointermove',e=>{if(!drag)return;
 az+=(e.clientX-drag[0])*0.01; el+=(e.clientY-drag[1])*0.01;
 el=Math.max(-1.5,Math.min(1.5,el)); drag=[e.clientX,e.clientY];draw();});
cv.addEventListener('wheel',e=>{e.preventDefault();
 zoom*=e.deltaY<0?1.1:0.9;draw();});
poll();
</script></body></html>"""
