"""Reusable dashboard chart components (the `deeplearning4j-ui-components`
analog — the reference ships a TypeScript chart-component library under
deeplearning4j-ui-parent/deeplearning4j-ui-components/src/main/typescript/;
here it is one self-contained JS module, served at /assets/charts.js and
shared by every dashboard page, with zero external assets / egress).

The port's copy of the JAX package's `ui/components.py` (no framework in it).

Components:
    dl4j.line(svgEl|id, series, {names})   multi-series line chart
    dl4j.bars(svgEl|id, counts, lo, hi)    histogram bars
    dl4j.kvTable(el|id, rows)              key/value table
    dl4j.grid(el|id, header, rows)         generic table
    dl4j.palette                           series colors
"""

CHARTS_JS = r"""
const dl4j = (() => {
  const palette = ["#3366cc","#dc3912","#ff9900","#109618","#990099",
    "#0099c6","#dd4477","#66aa00","#b82e2e","#316395","#994499","#22aa99"];
  const el = x => typeof x === "string" ? document.getElementById(x) : x;
  const esc = s => String(s).replace(/&/g,'&amp;').replace(/</g,'&lt;')
                            .replace(/>/g,'&gt;');

  function line(target, series, opts) {
    const svg = el(target); svg.innerHTML = "";
    const names = (opts && opts.names) || null;
    const W = svg.width.baseVal.value, H = svg.height.baseVal.value, P = 36;
    let xs = [], ys = [];
    series.forEach(s => s.forEach(p => { xs.push(p[0]); ys.push(p[1]); }));
    if (!xs.length) return;
    const x0 = Math.min(...xs), x1 = Math.max(...xs);
    const y0 = Math.min(...ys), y1 = Math.max(...ys);
    const fx = v => P + (W-2*P) * (x1 > x0 ? (v-x0)/(x1-x0) : 0.5);
    const fy = v => H - P - (H-2*P) * (y1 > y0 ? (v-y0)/(y1-y0) : 0.5);
    let g = '';
    for (let i = 0; i <= 4; i++) {
      const y = y0 + (y1-y0)*i/4, py = fy(y);
      g += `<line x1="${P}" y1="${py}" x2="${W-P}" y2="${py}" stroke="#eee"/>`
         + `<text x="2" y="${py+4}" font-size="9">${y.toPrecision(3)}</text>`;
    }
    g += `<text x="${W/2}" y="${H-4}" font-size="9">`
       + `${x0.toFixed(0)} .. ${x1.toFixed(0)}</text>`;
    series.forEach((s, i) => {
      if (!s.length) return;
      const d = s.map((p, j) => (j ? 'L' : 'M')
        + fx(p[0]).toFixed(1) + ',' + fy(p[1]).toFixed(1)).join(' ');
      g += `<path d="${d}" fill="none" stroke="${palette[i%palette.length]}"`
         + ` stroke-width="1.5"/>`;
      if (names && names[i])
        g += `<text x="${W-P+2}" y="${16+12*i}" font-size="9"`
           + ` fill="${palette[i%palette.length]}">${esc(names[i])}</text>`;
    });
    svg.innerHTML = g;
  }

  function bars(target, counts, lo, hi) {
    const svg = el(target); svg.innerHTML = "";
    if (!counts || !counts.length) return;
    const W = svg.width.baseVal.value, H = svg.height.baseVal.value, P = 26;
    const m = Math.max(...counts, 1), bw = (W-2*P)/counts.length;
    let g = '';
    counts.forEach((c, i) => {
      const h = (H-2*P)*c/m;
      g += `<rect x="${P+i*bw}" y="${H-P-h}" width="${Math.max(bw-1,1)}"`
         + ` height="${h}" fill="#3366cc"/>`;
    });
    g += `<text x="${P}" y="${H-6}" font-size="9">`
       + `${lo !== undefined ? lo.toPrecision(3) : ''}</text>`;
    g += `<text x="${W-P-40}" y="${H-6}" font-size="9">`
       + `${hi !== undefined ? hi.toPrecision(3) : ''}</text>`;
    svg.innerHTML = g;
  }

  function scatter(target, points, opts) {
    // points: [[x, y, label?], ...]; one color per distinct label
    const svg = el(target); svg.innerHTML = "";
    if (!points || !points.length) return;
    const W = svg.width.baseVal.value, H = svg.height.baseVal.value, P = 30;
    const xs = points.map(p => p[0]), ys = points.map(p => p[1]);
    const x0 = Math.min(...xs), x1 = Math.max(...xs);
    const y0 = Math.min(...ys), y1 = Math.max(...ys);
    const fx = v => P + (W-2*P) * (x1 > x0 ? (v-x0)/(x1-x0) : 0.5);
    const fy = v => H - P - (H-2*P) * (y1 > y0 ? (v-y0)/(y1-y0) : 0.5);
    const labels = [...new Set(points.map(p => p[2]))];
    let g = '';
    points.forEach(p => {
      const c = palette[Math.max(labels.indexOf(p[2]), 0) % palette.length];
      g += `<circle cx="${fx(p[0]).toFixed(1)}" cy="${fy(p[1]).toFixed(1)}"`
         + ` r="2.5" fill="${c}" fill-opacity="0.7">`
         + `<title>${esc(p[2] !== undefined ? p[2] : '')}</title></circle>`;
    });
    labels.forEach((lb, i) => {
      if (lb === undefined) return;
      g += `<text x="${W-P+2}" y="${16+12*i}" font-size="9"`
         + ` fill="${palette[i%palette.length]}">${esc(lb)}</text>`;
    });
    svg.innerHTML = g;
  }

  async function applyI18n(lang) {
    const r = await fetch(`/i18n?lang=${encodeURIComponent(lang)}`);
    const cat = await r.json();
    document.querySelectorAll('[data-i18n]').forEach(n => {
      const t = cat[n.dataset.i18n];
      if (t) n.textContent = t;
    });
    document.querySelectorAll('[data-i18n-placeholder]').forEach(n => {
      const t = cat[n.dataset.i18nPlaceholder];
      if (t) n.placeholder = t;
    });
  }

  function kvTable(target, rows) {
    el(target).innerHTML = `<table><tr><th>field</th><th>value</th></tr>`
      + rows.map(([k, v]) =>
          `<tr><td>${esc(k)}</td><td>${esc(v)}</td></tr>`).join('')
      + `</table>`;
  }

  function grid(target, header, rows) {
    el(target).innerHTML = `<table><tr>`
      + header.map(h => `<th>${esc(h)}</th>`).join('') + `</tr>`
      + rows.map(r => `<tr>`
          + r.map(c => `<td>${esc(c)}</td>`).join('') + `</tr>`).join('')
      + `</table>`;
  }

  return { palette, line, bars, scatter, kvTable, grid, esc, applyI18n };
})();
"""

STYLE_CSS = """
 body{font-family:sans-serif;margin:0;background:#f4f6f8;color:#222}
 header{background:#223;color:#fff;padding:10px 16px;font-size:18px}
 header a{color:#9cf;text-decoration:none;margin-left:14px;font-size:13px}
 .row{display:flex;flex-wrap:wrap;gap:12px;padding:12px}
 .card{background:#fff;border-radius:6px;padding:10px 14px;
       box-shadow:0 1px 3px rgba(0,0,0,.15)}
 .card h3{margin:2px 0 8px 0;font-size:14px;color:#445}
 svg{background:#fafbfc;border:1px solid #e0e4e8}
 select{margin-left:12px}
 table{border-collapse:collapse;font-size:12px}
 td,th{border:1px solid #dde;padding:3px 8px;text-align:right}
 th{background:#eef}
 td:first-child,th:first-child{text-align:left}
"""
