"""Self-contained interactive HTML dashboards (no plotting dependency).

Port of ``forging_control_tpu/eval/html_dash.py`` (the reference's Plotly
dashboards with unified hover and a per-trajectory slider, ``Graphics.plot``
+ slider logic, ``Supervised Learning/Functions.py:1403-1609``): ONE
self-contained HTML file of inline SVG panels, a trajectory slider and a
shared hover cursor with per-series readouts, rendered by vanilla JS
embedded in the file.  No network, no dependencies; the same bytes as the
JAX package's for the same arrays.  Telemetry may hold NumPy arrays or the
port's tensors (moved to the host).

Input is the panel spec of ``eval/plots.py``, one spec per trajectory:
``panels_by_traj[k]`` is the panel list for trajectory k.
"""

from __future__ import annotations

import json
import os
from typing import Sequence

_TEMPLATE = """<!DOCTYPE html>
<html><head><meta charset="utf-8"><title>__TITLE__</title>
<style>
 body { font-family: system-ui, sans-serif; margin: 16px; background: #fafafa; }
 h2 { margin: 4px 0 12px; font-size: 18px; }
 .panel { background: #fff; border: 1px solid #ddd; border-radius: 6px;
          margin-bottom: 10px; padding: 6px 10px; }
 .panel h3 { margin: 2px 0 4px; font-size: 13px; color: #333; }
 .legend { font-size: 11px; color: #444; }
 .legend span { margin-right: 12px; }
 .readout { font-size: 11px; color: #111; font-family: monospace; }
 .slider-row { margin: 8px 0; font-size: 13px; }
 svg { display: block; width: 100%; }
</style></head><body>
<h2>__TITLE__</h2>
<div class="slider-row" id="sliderrow">
 trajectory <input type="range" id="traj" min="0" max="0" value="0" step="1">
 <span id="trajlabel">0</span>
</div>
<div id="panels"></div>
<script>
const DATA = __DATA__;
const W = 900, H = 150, ML = 60, MR = 10, MT = 6, MB = 18;
const COLORS = ['#1f77b4','#ff7f0e','#2ca02c','#d62728','#9467bd','#8c564b'];
const slider = document.getElementById('traj');
slider.max = DATA.length - 1;
if (DATA.length === 1) document.getElementById('sliderrow').style.display = 'none';
function extent(arr, lo, hi) {
  for (const v of arr) { if (v < lo) lo = v; if (v > hi) hi = v; }
  return [lo, hi];
}
function fmt(v) {
  if (v === null || v === undefined) return '';
  const a = Math.abs(v);
  return (a !== 0 && (a >= 1e5 || a < 1e-3)) ? v.toExponential(3) : v.toPrecision(5);
}
function render(k) {
  document.getElementById('trajlabel').textContent = k;
  const host = document.getElementById('panels');
  host.innerHTML = '';
  for (const p of DATA[k]) {
    let xlo = Infinity, xhi = -Infinity, ylo = Infinity, yhi = -Infinity;
    for (const s of p.series) {
      [xlo, xhi] = extent(s.x, xlo, xhi);
      [ylo, yhi] = extent(s.y, ylo, yhi);
    }
    for (const h of (p.h_lines || [])) [ylo, yhi] = extent([h], ylo, yhi);
    if (ylo === yhi) { ylo -= 1; yhi += 1; }
    const pad = 0.05 * (yhi - ylo); ylo -= pad; yhi += pad;
    const sx = v => ML + (v - xlo) / (xhi - xlo || 1) * (W - ML - MR);
    const sy = v => MT + (yhi - v) / (yhi - ylo) * (H - MT - MB);
    let svg = `<svg viewBox="0 0 ${W} ${H}">`;
    svg += `<line x1="${ML}" y1="${H-MB}" x2="${W-MR}" y2="${H-MB}" stroke="#999"/>`;
    svg += `<line x1="${ML}" y1="${MT}" x2="${ML}" y2="${H-MB}" stroke="#999"/>`;
    for (let i = 0; i <= 4; i++) {
      const yv = ylo + i * (yhi - ylo) / 4;
      svg += `<text x="${ML-4}" y="${sy(yv)+3}" font-size="9" fill="#666" text-anchor="end">${fmt(yv)}</text>`;
      svg += `<line x1="${ML}" y1="${sy(yv)}" x2="${W-MR}" y2="${sy(yv)}" stroke="#eee"/>`;
      const xv = xlo + i * (xhi - xlo) / 4;
      svg += `<text x="${sx(xv)}" y="${H-4}" font-size="9" fill="#666" text-anchor="middle">${fmt(xv)}</text>`;
    }
    for (const h of (p.h_lines || []))
      svg += `<line x1="${ML}" y1="${sy(h)}" x2="${W-MR}" y2="${sy(h)}" stroke="#d62728" stroke-dasharray="3,3"/>`;
    for (const v of (p.v_lines || []))
      svg += `<line x1="${sx(v)}" y1="${MT}" x2="${sx(v)}" y2="${H-MB}" stroke="#333" stroke-dasharray="3,3"/>`;
    p.series.forEach((s, i) => {
      const c = COLORS[i % COLORS.length];
      if (s.type === 'bar') {
        const bw = Math.max(1, (W - ML - MR) / s.x.length - 1);
        s.x.forEach((xv, j) => {
          svg += `<rect x="${sx(xv)-bw/2}" y="${Math.min(sy(s.y[j]), sy(0))}" width="${bw}" height="${Math.abs(sy(s.y[j])-sy(0))}" fill="${c}" opacity="0.7"/>`;
        });
      } else if (s.type === 'markers') {
        s.x.forEach((xv, j) => {
          svg += `<circle cx="${sx(xv)}" cy="${sy(s.y[j])}" r="1.5" fill="${c}"/>`;
        });
      } else {
        const pts = s.x.map((xv, j) => `${sx(xv).toFixed(1)},${sy(s.y[j]).toFixed(1)}`).join(' ');
        svg += `<polyline points="${pts}" fill="none" stroke="${c}" stroke-width="1.2"/>`;
      }
    });
    svg += `<line class="cursor" x1="-10" y1="${MT}" x2="-10" y2="${H-MB}" stroke="#888"/>`;
    svg += '</svg>';
    const div = document.createElement('div');
    div.className = 'panel';
    const legend = p.series.map((s, i) =>
      `<span style="color:${COLORS[i % COLORS.length]}">&#9644; ${s.label || ''}</span>`).join('');
    div.innerHTML = `<h3>${p.title || ''}</h3><div class="legend">${legend}` +
                    ` <span class="readout"></span></div>${svg}`;
    host.appendChild(div);
    const svgEl = div.querySelector('svg'), cursor = div.querySelector('.cursor'),
          readout = div.querySelector('.readout');
    svgEl.addEventListener('mousemove', ev => {
      const r = svgEl.getBoundingClientRect();
      const xv = xlo + ((ev.clientX - r.left) / r.width * W - ML) / (W - ML - MR) * (xhi - xlo);
      // unified hover: move every panel's cursor + readout to this x
      for (const d of host.children) {
        const cur = d.querySelector('.cursor'), ro = d.querySelector('.readout');
        const panelIdx = Array.prototype.indexOf.call(host.children, d);
        const pp = DATA[k][panelIdx];
        cur.setAttribute('x1', sx(xv)); cur.setAttribute('x2', sx(xv));
        ro.textContent = 'x=' + fmt(xv) + ' ' + pp.series.map(s => {
          let j = 0, best = Infinity;
          for (let m = 0; m < s.x.length; m++) {
            const dd = Math.abs(s.x[m] - xv);
            if (dd < best) { best = dd; j = m; }
          }
          return (s.label || '?') + '=' + fmt(s.y[j]);
        }).join(' ');
      }
    });
  }
}
slider.addEventListener('input', () => render(+slider.value));
render(0);
</script></body></html>
"""


def _jsonable(panels_by_traj):
    import numpy as np

    def conv(p):
        out = {"title": p.get("title", ""),
               "h_lines": [float(h) for h in p.get("h_lines", [])],
               "v_lines": [float(v) for v in p.get("v_lines", [])],
               "series": []}
        for s in p.get("series", []):
            y = np.asarray(s["y"], dtype=float)
            x = (np.asarray(s["x"], dtype=float) if s.get("x") is not None
                 else np.arange(len(y), dtype=float))
            ok = np.isfinite(y)
            out["series"].append({
                "label": s.get("label", ""), "type": s.get("type", "line"),
                "x": x[ok].tolist(), "y": y[ok].tolist()})
        return out

    return [[conv(p) for p in panels] for panels in panels_by_traj]


def render_html(panels_by_traj: Sequence[Sequence[dict]], path: str,
                title: str = "") -> str:
    """Write a self-contained interactive dashboard; returns ``path``.

    ``panels_by_traj``: one panel-spec list per trajectory (the slider
    pages through them, like the reference's per-trajectory visibility
    slider).  Pass a single-element list for a slider-free page.
    """
    html = (_TEMPLATE
            .replace("__TITLE__", title or "forging-control dashboard")
            .replace("__DATA__", json.dumps(_jsonable(panels_by_traj))))
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        f.write(html)
    return path


def dashboard_from_telemetry(telem, path: str, title: str = "closed loop",
                             max_traj: int = 16) -> str:
    """Per-trajectory closed-loop dashboard straight from a Telemetry batch."""
    from . import plots

    n = min(int(plots.host(telem.u).shape[0]), max_traj)
    return render_html([plots._telemetry_panels(telem, k) for k in range(n)],
                       path, title)


def solver_dashboard_from_telemetry(telem, path: str,
                                    title: str = "solver diagnostics",
                                    max_traj: int = 16) -> str:
    """Optimizer-diagnostics dashboard (Generate Data/Main.py:211-262)."""
    from . import plots

    n = min(int(plots.host(telem.u).shape[0]), max_traj)
    return render_html([plots.solver_panels(telem, k) for k in range(n)],
                       path, title)
