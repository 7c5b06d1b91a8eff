"""Self-contained interactive HTML point-cloud viewer.

The interactive half of the viz3d capability (reference
include/SlamCore-viz3d/viz3d_windows.h:97-213 — VTK/ImGui windows showing
the aggregated map + trajectory): on a headless accelerator host there is no GUI,
so this exports ONE standalone .html file — points and trajectory embedded
as base64 float32, rendered by an inline WebGL orbit viewer with zero
external dependencies (works from file:// on an air-gapped laptop).

    from ct_icp_torch.viewer import export_html
    export_html("run.html", points=map_xyz, trajectory=traj_xyz)

Controls: drag = orbit, wheel = zoom, shift-drag = pan,
keys 1/2 = point size, c = color mode (height / distance).

Counterpart of ``ct_icp_tpu/viewer.py``; the map comes from
``Odometry.get_map_points`` (K10 on the card).
"""

from __future__ import annotations

import base64
import json
from pathlib import Path
from typing import Optional

import numpy as np

_TEMPLATE = """<!DOCTYPE html>
<html><head><meta charset="utf-8"><title>ct_icp_torch viewer</title>
<style>
 html,body{margin:0;height:100%;overflow:hidden;background:#10131a;font:12px monospace}
 #hud{position:fixed;top:8px;left:10px;color:#9fb3c8;user-select:none;
      background:rgba(16,19,26,.7);padding:6px 8px;border-radius:4px}
 canvas{display:block;width:100vw;height:100vh}
</style></head><body>
<div id="hud"></div><canvas id="c"></canvas>
<script>
"use strict";
const META = __META__;
function decode(b64){const s=atob(b64);const a=new Uint8Array(s.length);
 for(let i=0;i<s.length;i++)a[i]=s.charCodeAt(i);return new Float32Array(a.buffer);}
const pts = decode("__POINTS__");      // xyzxyz...
const traj = decode("__TRAJ__");
const N = pts.length/3, NT = traj.length/3;

const cv=document.getElementById("c");
const gl=cv.getContext("webgl",{antialias:true});
const VS=`attribute vec3 p;uniform mat4 mvp;uniform float ps;uniform int mode;
uniform vec2 zr;uniform vec3 c0;varying vec3 col;
vec3 turbo(float t){t=clamp(t,0.,1.);
 return clamp(vec3(
  0.14+t*(4.6-t*(42.7-t*(132.1-t*(150.6-t*58.3)))),
  0.09+t*(2.2+t*(4.3-t*(14.0-t*(4.2+t*2.7)))),
  0.11+t*(12.6-t*(60.1-t*(109.1-t*(88.5-t*26.4))))),0.,1.);}
void main(){
 gl_Position=mvp*vec4(p,1.0);
 gl_PointSize=ps;
 float t = mode==0 ? (p.z-zr.x)/(zr.y-zr.x) : length(p-c0)/zr.y;
 col=turbo(t);
}`;
const FS=`precision mediump float;varying vec3 col;
void main(){vec2 d=gl_PointCoord-vec2(.5);if(dot(d,d)>.25)discard;
 gl_FragColor=vec4(col,1.0);}`;
const LVS=`attribute vec3 p;uniform mat4 mvp;
void main(){gl_Position=mvp*vec4(p,1.0);}`;
const LFS=`precision mediump float;uniform vec4 lc;void main(){gl_FragColor=lc;}`;
function prog(vs,fs){function sh(t,s){const h=gl.createShader(t);
 gl.shaderSource(h,s);gl.compileShader(h);
 if(!gl.getShaderParameter(h,gl.COMPILE_STATUS))throw gl.getShaderInfoLog(h);
 return h;}
 const p=gl.createProgram();gl.attachShader(p,sh(gl.VERTEX_SHADER,vs));
 gl.attachShader(p,sh(gl.FRAGMENT_SHADER,fs));gl.linkProgram(p);return p;}
const P=prog(VS,FS), L=prog(LVS,LFS);
const pbuf=gl.createBuffer();gl.bindBuffer(gl.ARRAY_BUFFER,pbuf);
gl.bufferData(gl.ARRAY_BUFFER,pts,gl.STATIC_DRAW);
const tbuf=gl.createBuffer();gl.bindBuffer(gl.ARRAY_BUFFER,tbuf);
gl.bufferData(gl.ARRAY_BUFFER,traj,gl.STATIC_DRAW);

// bounds
let lo=[1e30,1e30,1e30],hi=[-1e30,-1e30,-1e30];
for(let i=0;i<N;i++)for(let k=0;k<3;k++){const v=pts[3*i+k];
 if(v<lo[k])lo[k]=v;if(v>hi[k])hi[k]=v;}
const ctr=[(lo[0]+hi[0])/2,(lo[1]+hi[1])/2,(lo[2]+hi[2])/2];
const span=Math.max(hi[0]-lo[0],hi[1]-lo[1],hi[2]-lo[2],1e-3);

let az=-0.7, el=0.5, dist=span*1.4, tgt=ctr.slice(), psize=2.0, mode=0;
function mat(){
 const f=1.0/Math.tan(0.4), asp=cv.width/cv.height;
 const zn=span*0.001, zf=span*40.0;
 const ce=Math.cos(el),se=Math.sin(el),ca=Math.cos(az),sa=Math.sin(az);
 const eye=[tgt[0]+dist*ce*ca, tgt[1]+dist*ce*sa, tgt[2]+dist*se];
 // camera basis: z = normalize(eye - tgt), x = normalize(up x z), y = z x x
 let zx=eye[0]-tgt[0],zy=eye[1]-tgt[1],zz=eye[2]-tgt[2];
 const zl=Math.hypot(zx,zy,zz);zx/=zl;zy/=zl;zz/=zl;
 let xx=-zy, xy=zx, xz=0;                       // [0,0,1] x z
 const xl=Math.hypot(xx,xy,xz)||1e-9;xx/=xl;xy/=xl;xz/=xl;
 const yx=zy*xz-zz*xy, yy=zz*xx-zx*xz, yz=zx*xy-zy*xx;
 const tx=-(xx*eye[0]+xy*eye[1]+xz*eye[2]);
 const ty=-(yx*eye[0]+yy*eye[1]+yz*eye[2]);
 const tz=-(zx*eye[0]+zy*eye[1]+zz*eye[2]);
 const A=zf/(zn-zf), B=zn*zf/(zn-zf);
 // column-major mvp = proj(f, asp, A, B) * view
 return new Float32Array([
  f/asp*xx, f*yx, A*zx, -zx,
  f/asp*xy, f*yy, A*zy, -zy,
  f/asp*xz, f*yz, A*zz, -zz,
  f/asp*tx, f*ty, A*tz+B, -tz]);
}
function draw(){
 const dpr=window.devicePixelRatio||1;
 cv.width=innerWidth*dpr;cv.height=innerHeight*dpr;
 gl.viewport(0,0,cv.width,cv.height);
 gl.clearColor(0.063,0.075,0.102,1);gl.clear(gl.COLOR_BUFFER_BIT);
 gl.enable(gl.DEPTH_TEST);gl.clear(gl.DEPTH_BUFFER_BIT);
 const m=mat();
 gl.useProgram(P);
 gl.uniformMatrix4fv(gl.getUniformLocation(P,"mvp"),false,m);
 gl.uniform1f(gl.getUniformLocation(P,"ps"),psize*(window.devicePixelRatio||1));
 gl.uniform1i(gl.getUniformLocation(P,"mode"),mode);
 gl.uniform2f(gl.getUniformLocation(P,"zr"),lo[2],Math.max(hi[2],lo[2]+1e-3));
 gl.uniform3f(gl.getUniformLocation(P,"c0"),ctr[0],ctr[1],ctr[2]);
 const a=gl.getAttribLocation(P,"p");
 gl.bindBuffer(gl.ARRAY_BUFFER,pbuf);gl.enableVertexAttribArray(a);
 gl.vertexAttribPointer(a,3,gl.FLOAT,false,0,0);
 gl.drawArrays(gl.POINTS,0,N);
 if(NT>1){gl.useProgram(L);
  gl.uniformMatrix4fv(gl.getUniformLocation(L,"mvp"),false,m);
  gl.uniform4f(gl.getUniformLocation(L,"lc"),1.0,0.42,0.21,1.0);
  const b=gl.getAttribLocation(L,"p");
  gl.bindBuffer(gl.ARRAY_BUFFER,tbuf);gl.enableVertexAttribArray(b);
  gl.vertexAttribPointer(b,3,gl.FLOAT,false,0,0);
  gl.drawArrays(gl.LINE_STRIP,0,NT);}
 hud();
}
function hud(){document.getElementById("hud").textContent=
 META.title+"  |  "+N.toLocaleString()+" pts, "+NT+" poses  |  "+
 "drag orbit / shift-drag pan / wheel zoom / 1,2 size / c color";}
let drag=null;
cv.addEventListener("mousedown",e=>drag=[e.clientX,e.clientY,e.shiftKey]);
addEventListener("mouseup",()=>drag=null);
addEventListener("mousemove",e=>{if(!drag)return;
 const dx=e.clientX-drag[0],dy=e.clientY-drag[1];
 if(drag[2]){const s=dist*0.0015;
  const ca=Math.cos(az),sa=Math.sin(az);
  tgt[0]+= s*(dx*sa);tgt[1]+= s*(-dx*ca);tgt[2]+= s*dy;}
 else{az-=dx*0.006;el=Math.min(1.55,Math.max(-1.55,el+dy*0.006));}
 drag=[e.clientX,e.clientY,drag[2]];requestAnimationFrame(draw);});
cv.addEventListener("wheel",e=>{e.preventDefault();
 dist*=Math.exp(e.deltaY*0.001);requestAnimationFrame(draw);},{passive:false});
addEventListener("keydown",e=>{
 if(e.key==="1")psize=Math.max(1,psize-0.5);
 if(e.key==="2")psize=Math.min(10,psize+0.5);
 if(e.key==="c")mode=1-mode;
 requestAnimationFrame(draw);});
addEventListener("resize",()=>requestAnimationFrame(draw));
draw();
</script></body></html>
"""


def export_html(path, points: np.ndarray,
                trajectory: Optional[np.ndarray] = None,
                title: str = "ct_icp_torch", max_points: int = 1_500_000):
    """Write a standalone interactive viewer HTML.

    Args:
      path: output .html path.
      points: [N, 3] float array (any frame).
      trajectory: optional [T, 3] pose positions drawn as a polyline.
      max_points: uniform decimation bound (keeps the file and the WebGL
        buffer tractable; 1.5M points ~ 18 MB base64).
    """
    pts = np.ascontiguousarray(np.asarray(points, np.float32))
    if pts.ndim != 2 or pts.shape[1] != 3:
        raise ValueError(f"points must be [N, 3], got {pts.shape}")
    if len(pts) > max_points:
        pts = pts[:: len(pts) // max_points + 1]
    traj = (np.ascontiguousarray(np.asarray(trajectory, np.float32))
            if trajectory is not None and len(np.atleast_2d(trajectory))
            else np.zeros((0, 3), np.float32))
    html = (_TEMPLATE
            .replace("__META__", json.dumps({"title": title}))
            .replace("__POINTS__", base64.b64encode(pts.tobytes()).decode())
            .replace("__TRAJ__", base64.b64encode(traj.tobytes()).decode()))
    Path(path).write_text(html)
    return Path(path)


def export_odometry_html(odometry, path, level: int = 0,
                         title: str = "ct_icp_torch map"):
    """Viewer for a live odometry: map points of ``level`` + trajectory
    (the live-window analog of the reference's MultiPolyDataWindow)."""
    data = odometry.get_map_points(level)
    pts = data[:, :3] if data.shape[0] else np.zeros((0, 3), np.float32)
    traj = np.stack([p.end_pose.tr + odometry.origin
                     for p in odometry.get_trajectory()]) \
        if odometry.get_trajectory() else None
    return export_html(path, pts, traj, title=title)
