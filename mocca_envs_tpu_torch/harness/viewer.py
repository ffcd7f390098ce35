"""Interactive trajectory viewer: record a rollout, replay it in a browser.

Counterpart of ``mocca_envs_tpu/harness/viewer.py``, with its own copy of
the page template. A batched env has no live sim loop a GUI could hook, so
the render path is RECORD → interactive REPLAY: ``export_html`` turns a
``harness/viz.dump_trajectory`` document into a self-contained HTML page (no
network, no external JS) with

  - orbit camera: mouse drag / arrow keys, wheel or +/- zoom,
  - camera FOLLOW of the robot root (key F),
  - pause/play (space), frame scrub (,/. keys and a slider), speed (1–4),
  - the full scene: ground grid, stone boxes, monkey-bar capsules,
    heightfield wireframe, mesh triangles, collision spheres, markers.

CLI (the rollout runs on the CUDA card; ``main(argv, device="cpu")`` runs
it on the CPU):
    python -m mocca_envs_tpu_torch.harness.viewer --dump traj.json --out view.html
    python -m mocca_envs_tpu_torch.harness.viewer --env Walker3DStairsEnv \
        --steps 120 --out view.html        # record a rollout, then export
"""

from __future__ import annotations

import argparse
import json
import os

_TEMPLATE = r"""<!DOCTYPE html>
<html>
<head>
<meta charset="utf-8">
<title>mocca_envs_tpu_torch viewer</title>
<style>
  body { margin:0; background:#16161d; color:#ddd;
         font:13px/1.4 system-ui, sans-serif; overflow:hidden; }
  #hud { position:fixed; left:10px; top:8px; user-select:none;
         background:rgba(22,22,29,.75); padding:6px 10px; border-radius:6px; }
  #hud b { color:#fff; }
  #bar { position:fixed; left:10px; right:10px; bottom:10px; }
  #scrub { width:100%; }
  canvas { display:block; }
  kbd { background:#333; border-radius:3px; padding:0 4px; color:#eee; }
</style>
</head>
<body>
<canvas id="c"></canvas>
<div id="hud"></div>
<div id="bar"><input id="scrub" type="range" min="0" value="0" step="1"></div>
<script>
const DOC = __DOC_JSON__;
const cv = document.getElementById('c'), ctx = cv.getContext('2d');
const hud = document.getElementById('hud');
const scrub = document.getElementById('scrub');
let W, H; function resize(){ W=cv.width=innerWidth; H=cv.height=innerHeight; }
addEventListener('resize', resize); resize();

const F = DOC.frames, SF = DOC.sphere_frames || null;
const N = F.length; scrub.max = N - 1;
let t = 0, playing = true, speed = 1, follow = true;
let yaw = -2.4, pitch = 0.45, dist = 4.0, center = [0, 0, 0.8];

function rootOf(i){ return F[i][0]; }
function project(p){
  // world (z-up) -> camera orbit -> screen
  const cy = Math.cos(yaw), sy = Math.sin(yaw);
  const cp = Math.cos(pitch), sp = Math.sin(pitch);
  const x = p[0]-center[0], y = p[1]-center[1], z = p[2]-center[2];
  const x1 =  cy*x + sy*y, y1 = -sy*x + cy*y;          // yaw about z
  const y2 =  cp*y1 + sp*z, z2 = -sp*y1 + cp*z;        // pitch
  const d  = x1 + dist;                                 // depth along view
  const s  = 0.9 * Math.min(W, H) / Math.max(d, 0.1);
  return [W/2 + y2*s, H/2 - z2*s, d, s];
}
function line(a, b, color, w){
  const A = project(a), B = project(b);
  if (A[2] < 0.12 || B[2] < 0.12) return;
  ctx.strokeStyle = color; ctx.lineWidth = w || 1;
  ctx.beginPath(); ctx.moveTo(A[0], A[1]); ctx.lineTo(B[0], B[1]); ctx.stroke();
}
function circle(p, r, color){
  const P = project(p);
  if (P[2] < 0.12) return;
  ctx.fillStyle = color;
  ctx.beginPath(); ctx.arc(P[0], P[1], Math.max(r*P[3], 1), 0, 6.28); ctx.fill();
}
function poly(pts, fill, stroke){
  const Ps = pts.map(project);
  if (Ps.some(P => P[2] < 0.12)) return;
  ctx.beginPath(); ctx.moveTo(Ps[0][0], Ps[0][1]);
  for (let i = 1; i < Ps.length; i++) ctx.lineTo(Ps[i][0], Ps[i][1]);
  ctx.closePath();
  if (fill){ ctx.fillStyle = fill; ctx.fill(); }
  if (stroke){ ctx.strokeStyle = stroke; ctx.lineWidth = 1; ctx.stroke(); }
}
function quatRot(q, v){            // wxyz
  const [w,x,y,z] = q, [vx,vy,vz] = v;
  const tx = 2*(y*vz - z*vy), ty = 2*(z*vx - x*vz), tz = 2*(x*vy - y*vx);
  return [vx + w*tx + (y*tz - z*ty),
          vy + w*ty + (z*tx - x*tz),
          vz + w*tz + (x*ty - y*tx)];
}
function drawScene(){
  const sc = DOC.scene || {};
  const gz = sc.ground_z !== undefined ? sc.ground_z : 0;
  if (gz > -100){
    const cx = Math.round(center[0]), cyy = Math.round(center[1]);
    for (let i = -6; i <= 6; i++){
      line([cx+i, cyy-6, gz], [cx+i, cyy+6, gz], '#2d2d3a');
      line([cx-6, cyy+i, gz], [cx+6, cyy+i, gz], '#2d2d3a');
    }
  }
  if (sc.stones){
    const {pos, quat, half, active} = sc.stones;
    for (let k = 0; k < pos.length; k++){
      if (active && active[k] < 0.5) continue;
      const p = pos[k], q = quat[k], h = half[k];
      const cs = [];
      for (const sx of [-1,1]) for (const sy of [-1,1])
        cs.push(quatRot(q, [sx*h[0], sy*h[1], h[2]]).map((v,i)=>v+p[i]));
      poly([cs[0],cs[1],cs[3],cs[2]], 'rgba(110,160,110,.45)', '#8c8');
      for (const sx of [-1,1]) for (const sy of [-1,1]){
        const top = quatRot(q, [sx*h[0], sy*h[1],  h[2]]).map((v,i)=>v+p[i]);
        const bot = quatRot(q, [sx*h[0], sy*h[1], -h[2]]).map((v,i)=>v+p[i]);
        line(top, bot, '#575');
      }
    }
  }
  if (sc.bars){
    const {a, b, r} = sc.bars;
    for (let k = 0; k < a.length; k++){
      const P = project(a[k]);
      line(a[k], b[k], '#c9a227', Math.max((r[k]||0.02)*2*P[3], 2));
    }
  }
  if (sc.tris){
    const {a, b, c} = sc.tris;
    for (let k = 0; k < a.length; k++)
      poly([a[k], b[k], c[k]], 'rgba(120,120,170,.35)', '#77a');
  }
  if (sc.heightfield){
    const {xy0, cell, height} = sc.heightfield;
    const Hh = height.length, Wh = height[0].length;
    const st = Math.max(1, Math.floor(Math.max(Hh, Wh)/32));
    for (let i = 0; i < Hh-st; i += st)
      for (let j = 0; j < Wh-st; j += st){
        const p00=[xy0[0]+i*cell,      xy0[1]+j*cell,      height[i][j]];
        const p10=[xy0[0]+(i+st)*cell, xy0[1]+j*cell,      height[i+st][j]];
        const p01=[xy0[0]+i*cell,      xy0[1]+(j+st)*cell, height[i][j+st]];
        line(p00, p10, '#35505a'); line(p00, p01, '#35505a');
      }
  }
}
function draw(){
  ctx.clearRect(0, 0, W, H);
  if (follow){
    const r = rootOf(t);
    center = [center[0]*.85 + r[0]*.15, center[1]*.85 + r[1]*.15,
              center[2]*.85 + (r[2]*.5+0.4)*.15];
  }
  drawScene();
  const pos = F[t], par = DOC.parent || [];
  for (let l = 1; l < pos.length; l++)
    line(pos[par[l] !== undefined ? par[l] : 0], pos[l], '#9ab', 2);
  const S = DOC.spheres || null;
  if (SF && S)
    for (let s = 0; s < SF[t].length; s++)
      circle(SF[t][s], S.radius[s], 'rgba(240,150,90,.85)');
  else
    for (let l = 0; l < pos.length; l++) circle(pos[l], 0.04, '#f96');
  if (DOC.markers)
    for (let m = 0; m < DOC.markers.frames[t].length; m++)
      circle(DOC.markers.frames[t][m],
             DOC.markers.desc[m].radius || 0.05, 'rgba(120,200,255,.9)');
  hud.innerHTML = `<b>frame ${t}/${N-1}</b> speed ${speed}x ` +
    `${playing ? '&#9654;' : '&#10074;&#10074;'} follow ${follow ? 'ON' : 'off'}<br>` +
    `<kbd>space</kbd> play <kbd>,</kbd>/<kbd>.</kbd> step <kbd>F</kbd> follow ` +
    `<kbd>1-4</kbd> speed <kbd>drag/arrows</kbd> orbit <kbd>wheel</kbd> zoom`;
  scrub.value = t;
}
let acc = 0;
function tick(){
  if (playing){ acc += speed; while (acc >= 1){ t = (t+1) % N; acc -= 1; } }
  draw(); requestAnimationFrame(tick);
}
addEventListener('keydown', e => {
  if (e.code === 'Space'){ playing = !playing; e.preventDefault(); }
  else if (e.key === ',') { playing = false; t = (t+N-1) % N; }
  else if (e.key === '.') { playing = false; t = (t+1) % N; }
  else if (e.key === 'f' || e.key === 'F') follow = !follow;
  else if (e.key >= '1' && e.key <= '4') speed = +e.key;
  else if (e.key === 'ArrowLeft')  yaw -= 0.08;
  else if (e.key === 'ArrowRight') yaw += 0.08;
  else if (e.key === 'ArrowUp')    pitch = Math.min(1.5, pitch + 0.06);
  else if (e.key === 'ArrowDown')  pitch = Math.max(-0.2, pitch - 0.06);
  else if (e.key === '+' || e.key === '=') dist = Math.max(0.8, dist*0.9);
  else if (e.key === '-') dist = Math.min(40, dist/0.9);
});
let drag = null;
cv.addEventListener('mousedown', e => drag = [e.clientX, e.clientY]);
addEventListener('mouseup', () => drag = null);
addEventListener('mousemove', e => {
  if (!drag) return;
  yaw   += (e.clientX - drag[0]) * 0.008;
  pitch  = Math.min(1.5, Math.max(-0.2, pitch + (e.clientY - drag[1])*0.006));
  drag = [e.clientX, e.clientY];
});
addEventListener('wheel', e => {
  dist = Math.min(40, Math.max(0.8, dist * (e.deltaY > 0 ? 1.1 : 0.9)));
});
scrub.addEventListener('input', () => { playing = false; t = +scrub.value; });
tick();
</script>
</body>
</html>
"""


def export_html(doc, out_path: str) -> str:
    """Render a dump_trajectory doc (dict or JSON path) to a standalone
    interactive HTML viewer. Returns ``out_path``."""
    if isinstance(doc, str):
        with open(doc) as f:
            doc = json.load(f)
    html = _TEMPLATE.replace("__DOC_JSON__", json.dumps(doc))
    os.makedirs(os.path.dirname(os.path.abspath(out_path)), exist_ok=True)
    with open(out_path, "w") as f:
        f.write(html)
    return out_path


def record_rollout_doc(env_id: str, steps: int = 120, seed: int = 0,
                       every: int = 1, policy=None, device=None) -> dict:
    """Roll one env on ``device`` (None = the CUDA card) with zero actions
    unless ``policy(obs) → action``, auto-reset on, and build the replay doc
    in memory — the record half of record→replay. The frames stay on the
    device until the rollout ends."""
    import numpy as np
    import torch

    import mocca_envs_tpu_torch
    from mocca_envs_tpu_torch.core import rng as rng_mod
    from mocca_envs_tpu_torch.harness.viz import scene_to_desc, trajectory_doc

    env = mocca_envs_tpu_torch.make(env_id, device=device)
    model = getattr(env, "model", None)
    if model is None:
        raise ValueError(f"{env_id} exposes no .model for FK replay")
    gen = rng_mod.generator(seed, env.device)
    state = env.init(gen, 1)
    qs = [state.q[0]]
    zeros = torch.zeros(1, env.act_dim, device=env.device)
    for _ in range(steps):
        if policy is None:
            a = zeros
        else:
            obs = env.obs_fn(state)[0].cpu().numpy()
            a = torch.as_tensor(np.asarray(policy(obs), np.float32),
                                device=env.device).reshape(1, -1)
        state = env.step(state, a, gen).state
        qs.append(state.q[0])
    return trajectory_doc(model, torch.stack(qs), every=every,
                          scene_desc=scene_to_desc(state.scene))


def main(argv=None, device=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--dump", default=None,
                    help="existing dump_trajectory JSON to wrap")
    ap.add_argument("--env", default=None,
                    help="or: record a fresh rollout of this env id")
    ap.add_argument("--steps", type=int, default=120)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", required=True, help="output .html path")
    args = ap.parse_args(argv)
    if args.dump:
        doc = args.dump
    elif args.env:
        doc = record_rollout_doc(args.env, steps=args.steps, seed=args.seed, device=device)
    else:
        ap.error("need --dump or --env")
    path = export_html(doc, args.out)
    print(f"wrote {path}")


if __name__ == "__main__":
    main()
