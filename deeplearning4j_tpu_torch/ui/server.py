"""UIServer — the training dashboard.

Parity: DL4J `deeplearning4j-play/.../play/PlayUIServer.java` +
`module/train/TrainModule.java` (overview / model / system tabs fed by an
attached StatsStorage, live-updating browser charts).

The port's copy of the JAX package's `ui/server.py` (framework-neutral:
the standard library and the port's `monitor`). A stdlib
ThreadingHTTPServer serving self-contained HTML pages (SVG charts drawn by the shared /assets/charts.js component
module — the `deeplearning4j-ui-components` analog, see ui/components.py —
no external assets, zero egress) that poll JSON endpoints. Endpoints
mirror TrainModule's routes:
    /train            (overview tab: score, throughput, memory, ratios)
    /train/model      (model tab: per-layer drill-down)
    /train/sessions            -> session ids
    /train/data?sid=&after=    -> static info + updates since a timestamp
    /assets/charts.js          -> reusable chart components
    /train/system, /tsne, /word2vec, /i18n, /metrics, POST /remoteReceive,
    POST /tsne/post/<sid>
"""
from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, Optional
from urllib.parse import parse_qs, unquote, urlparse

from deeplearning4j_tpu_torch.ui.components import CHARTS_JS, STYLE_CSS
from deeplearning4j_tpu_torch.ui.storage import StatsStorage

_HEAD = f"""<!DOCTYPE html>
<html><head><meta charset="utf-8"><title>DL4J Training UI</title>
<style>{STYLE_CSS}</style>
<script src="/assets/charts.js"></script>
</head><body>
<header>DL4J Training Dashboard
 <a href="/train" data-i18n="train.nav.overview">overview</a><a
  href="/train/model" data-i18n="train.nav.model">model</a><a
  href="/train/system" data-i18n="train.nav.system">system</a><a
  href="/tsne" data-i18n="train.nav.tsne">t-SNE</a><a
  href="/word2vec" data-i18n="train.nav.word2vec">word2vec</a>
 <select id="sess"></select>
 <select id="lang" onchange="dl4j.applyI18n(this.value)">
  <option>en</option><option>de</option><option>ja</option>
  <option>ko</option><option>ru</option><option>zh</option></select>
 <span id="status" style="font-size:12px;margin-left:12px"></span>
</header>
<script>
let updates=[], statics={{}}, after=0, sid=null;
async function refreshSessions(){{
  const r=await fetch('/train/sessions'); const j=await r.json();
  const sel=document.getElementById('sess');
  const cur=sel.value;
  sel.innerHTML=j.sessions.map(s=>`<option>${{dl4j.esc(s)}}</option>`).join('');
  if(j.sessions.includes(cur))sel.value=cur;
  if(!sid&&j.sessions.length){{sid=sel.value;}}
}}
async function poll(){{
  try{{
    await refreshSessions();
    const sel=document.getElementById('sess');
    if(sel.value&&sel.value!==sid){{sid=sel.value;updates=[];after=0;}}
    if(!sid){{setTimeout(poll,2000);return;}}
    const r=await fetch(`/train/data?sid=${{encodeURIComponent(sid)}}&after=${{after}}`);
    const j=await r.json();
    statics=j.static||{{}};
    if(j.updates.length){{
      updates=updates.concat(j.updates);
      after=j.updates[j.updates.length-1].timestamp;
      if(updates.length>2000)updates=updates.slice(-2000);
    }}
    render();
    document.getElementById('status').textContent=
      `${{updates.length}} records | live`;
  }}catch(e){{document.getElementById('status').textContent='disconnected';}}
  setTimeout(poll,2000);
}}
</script>
"""

_OVERVIEW_PAGE = _HEAD + """
<div class="row">
 <div class="card"><h3 data-i18n="train.overview.chart.score">Score vs iteration</h3><svg id="score" width="460" height="220"></svg></div>
 <div class="card"><h3 data-i18n="train.overview.chart.throughput">Samples/sec</h3><svg id="perf" width="460" height="220"></svg></div>
 <div class="card"><h3 data-i18n="train.overview.chart.memory">Device memory (MB in use)</h3><svg id="mem" width="460" height="220"></svg></div>
</div>
<div class="row">
 <div class="card"><h3 data-i18n="train.overview.chart.paramMag">Parameter mean magnitudes (log10)</h3><svg id="pmag" width="700" height="240"></svg></div>
 <div class="card"><h3 data-i18n="train.overview.chart.ratio">Update:param ratio (log10, healthy ~ -3)</h3><svg id="ratio" width="700" height="240"></svg></div>
</div>
<div class="row">
 <div class="card"><h3 data-i18n="train.overview.info">Model / session info</h3><div id="info" style="font-size:12px"></div></div>
 <div class="card"><h3><span data-i18n="train.overview.chart.gradHist">Last gradient histogram</span> <select id="hsel"></select></h3>
  <svg id="hist" width="460" height="220"></svg></div>
</div>
<script>
function render(){
  const d=updates.map(u=>u.data);
  dl4j.line('score',[d.map(u=>[u.iteration,u.score])]);
  dl4j.line('perf',[d.filter(u=>u.samples_sec>0).map(u=>[u.iteration,u.samples_sec])]);
  dl4j.line('mem',[d.filter(u=>u.memory&&u.memory.device_bytes_in_use)
     .map(u=>[u.iteration,u.memory.device_bytes_in_use/1048576])]);
  const last=d[d.length-1]; if(!last)return;
  const keys=Object.keys(last.params||{});
  dl4j.line('pmag',keys.map(k=>d.filter(u=>u.params&&u.params[k])
     .map(u=>[u.iteration,Math.log10(u.params[k].mean_mag+1e-12)])),{names:keys});
  dl4j.line('ratio',keys.map(k=>d.filter(u=>u.updates&&u.updates[k]&&u.params[k])
     .map(u=>[u.iteration,Math.log10((u.updates[k].mean_mag+1e-12)/(u.params[k].mean_mag+1e-12))])),{names:keys});
  const hsel=document.getElementById('hsel');
  const gkeys=Object.keys(last.gradients||{});
  if(hsel.options.length!==gkeys.length){
    hsel.innerHTML=gkeys.map(k=>`<option>${dl4j.esc(k)}</option>`).join('');}
  const histKey=hsel.value||gkeys[0];
  if(histKey&&last.gradients&&last.gradients[histKey]){
    const h=last.gradients[histKey];
    dl4j.bars('hist',h.hist,h.lo,h.hi);}
  const si=statics.data||{};
  dl4j.kvTable('info',
    ['model_class','num_params','num_layers','devices'].map(k=>
      [k,JSON.stringify(si[k])])
    .concat([['score (last)',last.score.toPrecision(5)],
             ['iteration',last.iteration]]));
  if(si.summary)document.getElementById('info').innerHTML+=
    `<pre style="font-size:11px">${dl4j.esc(si.summary)}</pre>`;
}
poll();
</script></body></html>
"""

_MODEL_PAGE = _HEAD + """
<div class="row">
 <div class="card" style="min-width:280px"><h3 data-i18n="train.model.layers">Layers (click to select)</h3>
  <div id="ltable" style="font-size:12px"></div></div>
 <div class="card"><h3 id="ltitle">Layer</h3><div id="ldetail" style="font-size:12px"></div></div>
</div>
<div class="row">
 <div class="card"><h3 data-i18n="train.model.paramMag">Mean magnitude: parameters (log10)</h3><svg id="lpmag" width="460" height="220"></svg></div>
 <div class="card"><h3 data-i18n="train.model.gradMag">Mean magnitude: gradients (log10)</h3><svg id="lgmag" width="460" height="220"></svg></div>
 <div class="card"><h3>Update:param ratio (log10)</h3><svg id="lratio" width="460" height="220"></svg></div>
</div>
<div class="row">
 <div class="card"><h3>Parameter histogram <select id="lpsel"></select></h3>
  <svg id="lphist" width="460" height="220"></svg></div>
 <div class="card"><h3>Gradient histogram</h3><svg id="lghist" width="460" height="220"></svg></div>
 <div class="card"><h3>Update histogram</h3><svg id="luhist" width="460" height="220"></svg></div>
</div>
<script>
let layer=null;
function layerKeys(rec, group, name){
  return Object.keys(rec[group]||{}).filter(k=>k.split('/')[0]===name);
}
function selectLayer(name){ layer=name; render(); }
function render(){
  const si=statics.data||{};
  const layers=si.layers||[];
  if(layer===null&&layers.length)layer=layers[0].name;
  dl4j.grid('ltable',['layer','type','n_params'],
    layers.map(l=>[l.name,l.type,l.n_params]));
  // row click-through: rebuild with onclick handles
  const rows=document.querySelectorAll('#ltable tr');
  layers.forEach((l,i)=>{
    const tr=rows[i+1]; if(!tr)return;
    tr.style.cursor='pointer';
    if(l.name===layer)tr.style.background='#dde8ff';
    tr.onclick=()=>selectLayer(l.name);
  });
  const d=updates.map(u=>u.data);
  const last=d[d.length-1];
  if(!last||layer===null)return;
  const info=layers.find(l=>l.name===layer)||{};
  document.getElementById('ltitle').textContent=
    `Layer ${layer} (${info.type||'?'})`;
  dl4j.kvTable('ldetail',
    [['type',info.type],['n_params',info.n_params]].concat(
      Object.entries(info.shapes||{}).map(([k,v])=>
        ['shape '+k,JSON.stringify(v)])));
  const pkeys=layerKeys(last,'params',layer);
  dl4j.line('lpmag',pkeys.map(k=>d.filter(u=>u.params&&u.params[k])
    .map(u=>[u.iteration,Math.log10(u.params[k].mean_mag+1e-12)])),{names:pkeys});
  const gkeys=layerKeys(last,'gradients',layer);
  dl4j.line('lgmag',gkeys.map(k=>d.filter(u=>u.gradients&&u.gradients[k])
    .map(u=>[u.iteration,Math.log10(u.gradients[k].mean_mag+1e-12)])),{names:gkeys});
  dl4j.line('lratio',pkeys.map(k=>d.filter(u=>u.updates&&u.updates[k]&&u.params[k])
    .map(u=>[u.iteration,Math.log10((u.updates[k].mean_mag+1e-12)/(u.params[k].mean_mag+1e-12))])),{names:pkeys});
  const sel=document.getElementById('lpsel');
  if(sel.dataset.keys!==pkeys.join()){   // layer switch: rebuild options
    sel.innerHTML=pkeys.map(k=>`<option>${dl4j.esc(k)}</option>`).join('');
    sel.dataset.keys=pkeys.join();
  }
  const pk=sel.value||pkeys[0];
  if(pk&&last.params[pk]&&last.params[pk].hist)
    dl4j.bars('lphist',last.params[pk].hist,last.params[pk].lo,last.params[pk].hi);
  const gk=(layerKeys(last,'gradients',layer))[Math.max(0,sel.selectedIndex)];
  if(gk&&last.gradients[gk]&&last.gradients[gk].hist)
    dl4j.bars('lghist',last.gradients[gk].hist,last.gradients[gk].lo,last.gradients[gk].hi);
  const uk=(layerKeys(last,'updates',layer))[Math.max(0,sel.selectedIndex)];
  if(uk&&last.updates[uk]&&last.updates[uk].hist)
    dl4j.bars('luhist',last.updates[uk].hist,last.updates[uk].lo,last.updates[uk].hi);
}
poll();
</script></body></html>
"""


_SYSTEM_PAGE = _HEAD + """
<div class="row">
 <div class="card"><h3>Devices</h3><div id="devs" style="font-size:12px"></div></div>
 <div class="card"><h3>Host memory (max RSS, MB)</h3><svg id="rss" width="460" height="220"></svg></div>
 <div class="card"><h3>Device memory (MB in use)</h3><svg id="dmem" width="460" height="220"></svg></div>
</div>
<div class="row">
 <div class="card"><h3>Iteration time (ms)</h3><svg id="itms" width="460" height="220"></svg></div>
 <div class="card"><h3>ETL time (ms)</h3><svg id="etl" width="460" height="220"></svg></div>
</div>
<script>
function render(){
  const d=updates.map(u=>u.data);
  const si=statics.data||{};
  dl4j.kvTable('devs',[['devices',JSON.stringify(si.devices)],
    ['model_class',si.model_class],['num_params',si.num_params]]);
  dl4j.line('rss',[d.filter(u=>u.memory&&u.memory.host_max_rss_kb)
    .map(u=>[u.iteration,u.memory.host_max_rss_kb/1024])]);
  dl4j.line('dmem',[d.filter(u=>u.memory&&u.memory.device_bytes_in_use)
    .map(u=>[u.iteration,u.memory.device_bytes_in_use/1048576])]);
  dl4j.line('itms',[d.filter(u=>u.iter_ms>0).map(u=>[u.iteration,u.iter_ms])]);
  dl4j.line('etl',[d.map(u=>[u.iteration,u.etl_ms])]);
}
poll();
</script></body></html>
"""

_TSNE_PAGE = _HEAD + """
<div class="row">
 <div class="card"><h3 data-i18n="tsne.title">t-SNE embedding</h3>
  <select id="tsess"></select>
  <svg id="plot" width="760" height="560"></svg></div>
</div>
<script>
function render(){}
async function tsnePoll(){
  try{
    const r=await fetch('/tsne/sessions'); const j=await r.json();
    const sel=document.getElementById('tsess');
    const cur=sel.value;
    sel.innerHTML=j.sessions.map(s=>`<option>${dl4j.esc(s)}</option>`).join('');
    if(j.sessions.includes(cur))sel.value=cur;
    if(sel.value){
      const c=await fetch(`/tsne/coords/${encodeURIComponent(sel.value)}`);
      const d=await c.json();
      dl4j.scatter('plot', d.points);
      document.getElementById('status').textContent=
        `${d.points.length} points`;
    }
  }catch(e){document.getElementById('status').textContent='disconnected';}
  setTimeout(tsnePoll,3000);
}
tsnePoll();
</script></body></html>
"""

_W2V_PAGE = _HEAD + """
<div class="row">
 <div class="card"><h3 data-i18n="word2vec.title">Nearest words</h3>
  <input id="word" data-i18n-placeholder="word2vec.prompt" placeholder="word">
  <input id="topn" type="number" value="10" style="width:52px">
  <button onclick="query()">&rarr;</button>
  <div id="result" style="font-size:13px;margin-top:10px"></div></div>
</div>
<script>
function render(){}
async function query(){
  const w=document.getElementById('word').value;
  const n=document.getElementById('topn').value;
  const r=await fetch(`/word2vec/nearest?word=${encodeURIComponent(w)}&n=${n}`);
  const j=await r.json();
  if(j.error){document.getElementById('result').textContent=j.error;return;}
  dl4j.grid('result',['word','similarity'],
    j.nearest.map(e=>[e.word,e.similarity.toFixed(4)]));
}
document.getElementById('word').addEventListener('keydown',
  e=>{if(e.key==='Enter')query();});
</script></body></html>
"""


class _Handler(BaseHTTPRequestHandler):
    server_version = "DL4J-UI/1.0"

    def log_message(self, *a):       # silence request logging
        pass

    def _json(self, obj, code=200):
        self._raw(json.dumps(obj).encode(), "application/json", code)

    def _raw(self, body: bytes, ctype: str, code: int = 200):
        self.send_response(code)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def do_GET(self):
        ui: "UIServer" = self.server.ui           # type: ignore[attr-defined]
        url = urlparse(self.path)
        if url.path in ("/", "/train", "/train/overview"):
            self._raw(_OVERVIEW_PAGE.encode(), "text/html; charset=utf-8")
            return
        if url.path == "/train/model":
            self._raw(_MODEL_PAGE.encode(), "text/html; charset=utf-8")
            return
        if url.path == "/train/system":
            self._raw(_SYSTEM_PAGE.encode(), "text/html; charset=utf-8")
            return
        if url.path == "/assets/charts.js":
            self._raw(CHARTS_JS.encode(),
                      "application/javascript; charset=utf-8")
            return
        if url.path == "/tsne":
            self._raw(_TSNE_PAGE.encode(), "text/html; charset=utf-8")
            return
        if url.path == "/word2vec":
            self._raw(_W2V_PAGE.encode(), "text/html; charset=utf-8")
            return
        if url.path == "/i18n":
            from deeplearning4j_tpu_torch.ui.i18n import catalog
            lang = parse_qs(url.query).get("lang", ["en"])[0]
            self._json(catalog(lang))
            return
        if url.path == "/tsne/sessions":
            with ui._tsne_lock:
                sessions = sorted(ui._tsne_sessions)
            self._json({"sessions": sessions})
            return
        if url.path.startswith("/tsne/coords/"):
            sid = unquote(url.path.rsplit("/", 1)[-1])
            with ui._tsne_lock:
                pts = ui._tsne_sessions.get(sid)
            if pts is None:
                self._json({"error": f"unknown t-SNE session '{sid}'"},
                           code=404)
            else:
                self._json({"points": pts})
            return
        if url.path == "/word2vec/nearest":
            q = parse_qs(url.query)
            word = q.get("word", [""])[0]
            try:
                n = max(1, int(q.get("n", ["10"])[0]))
            except ValueError:
                n = 10
            self._json(ui.nearest_words(word, n))
            return
        if url.path == "/train/sessions":
            self._json({"sessions": ui.session_ids()})
            return
        if url.path == "/metrics":
            # Prometheus text exposition of the process-global telemetry
            # registry (monitor/metrics.py) — scrape target for ops
            from deeplearning4j_tpu_torch.monitor import prometheus_text
            self._raw(prometheus_text().encode(),
                      "text/plain; version=0.0.4; charset=utf-8")
            return
        if url.path == "/train/data":
            q = parse_qs(url.query)
            sid = q.get("sid", [""])[0]
            try:
                after = float(q.get("after", ["0"])[0])
            except ValueError:
                self._json({"error": "bad 'after' parameter: not a number"},
                           code=400)
                return
            if sid not in ui.session_ids():
                self._json({"error": f"unknown session id '{sid}'"},
                           code=404)
                return
            self._json(ui.session_data(sid, after))
            return
        self._json({"error": "not found"}, code=404)

    def _post_body(self):
        """Read and json-parse the POST body; raises ValueError on a
        bad/abusive Content-Length or non-JSON payload (the caller maps
        that to a clean 400, never a 500 traceback)."""
        try:
            length = int(self.headers.get("Content-Length", "0"))
        except (TypeError, ValueError):
            raise ValueError("bad Content-Length header")
        if length < 0 or length > (64 << 20):
            raise ValueError(f"unreasonable Content-Length {length}")
        return json.loads(self.rfile.read(length) or b"{}")

    def do_POST(self):
        # TsneModule.java route parity: POST /tsne/post/<sid> with a JSON
        # body {"points": [[x, y, label?], ...]}
        ui: "UIServer" = self.server.ui           # type: ignore[attr-defined]
        url = urlparse(self.path)
        if url.path == "/remoteReceive":
            # RemoteReceiverModule.java:60 parity: workers' remote stats
            # routers POST record batches here; they land in the storage
            # registered via UIServer.enable_remote_listener()
            # AttributeError covers a well-formed-JSON body that is not an
            # object (e.g. a bare list: .get would 500 with a traceback)
            try:
                body = self._post_body()
                n = ui.receive_remote(body.get("records", []))
            except (ValueError, KeyError, TypeError, AttributeError) as e:
                self._json({"error": f"bad body: {e}"}, code=400)
                return
            if n is None:
                self._json({"error": "remote listener not enabled"},
                           code=409)
                return
            self._json({"ok": True, "n": n})
            return
        if url.path.startswith("/tsne/post/"):
            sid = unquote(url.path.rsplit("/", 1)[-1])
            try:
                body = self._post_body()
                pts = body["points"]
                ui.post_tsne(sid, pts)
            except (ValueError, KeyError, TypeError, IndexError,
                    AttributeError) as e:
                self._json({"error": f"bad body: {e}"}, code=400)
                return
            self._json({"ok": True, "n": len(pts)})
            return
        self._json({"error": "not found"}, code=404)


class UIServer:
    """Singleton dashboard server (PlayUIServer.getInstance() parity).

    Usage:
        server = UIServer.get_instance()     # starts on a free port
        server.attach(storage)
        print(server.url)
    """

    _instance: Optional["UIServer"] = None

    def __init__(self, port: int = 0, host: str = "127.0.0.1"):
        """`host` defaults to loopback; a dashboard process accepting
        remote worker stats from OTHER hosts (enable_remote_listener + workers using
        RemoteUIStatsStorageRouter) must bind host="0.0.0.0" like the
        reference's Play server does."""
        self._storages: list = []
        self._tsne_sessions: Dict[str, list] = {}
        self._tsne_lock = threading.Lock()
        self._word_vectors = None
        self._remote_storage = None
        self._httpd = ThreadingHTTPServer((host, port), _Handler)
        self._httpd.ui = self                    # type: ignore[attr-defined]
        self.port = self._httpd.server_address[1]
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        daemon=True, name="UIServer")
        self._thread.start()

    @classmethod
    def get_instance(cls, port: int = 0) -> "UIServer":
        if cls._instance is None:
            cls._instance = UIServer(port)
        return cls._instance

    @property
    def url(self) -> str:
        return f"http://127.0.0.1:{self.port}/"

    def attach(self, storage: StatsStorage):
        """Attach a stats storage to visualize (UIServer.attach parity)."""
        if storage not in self._storages:
            self._storages.append(storage)

    def enable_remote_listener(self, storage: Optional[StatsStorage] = None,
                               attach: bool = True) -> StatsStorage:
        """Accept stats POSTed by RemoteUIStatsStorageRouter workers at
        /remoteReceive, routing them into `storage` (a fresh
        InMemoryStatsStorage when omitted). Mirrors
        PlayUIServer.enableRemoteListener / RemoteReceiverModule."""
        if storage is None:
            from deeplearning4j_tpu_torch.ui.storage import InMemoryStatsStorage
            storage = InMemoryStatsStorage()
        self._remote_storage = storage
        if attach:
            self.attach(storage)
        return storage

    def disable_remote_listener(self):
        self._remote_storage = None

    def receive_remote(self, records) -> Optional[int]:
        """Route one POSTed record batch into the remote-listener storage.
        Returns the record count, or None if remote receiving is off.
        The whole batch is parsed BEFORE anything is stored: a malformed
        record rejects the batch atomically, so the sender's whole-batch
        retry cannot duplicate a partially-committed prefix."""
        from deeplearning4j_tpu_torch.ui.storage import StatsRecord
        if self._remote_storage is None:
            return None
        parsed = []
        for entry in records:
            entry = dict(entry)
            kind = entry.pop("kind", "update")
            parsed.append((kind, StatsRecord(**entry)))
        for kind, rec in parsed:
            if kind == "static":
                self._remote_storage.put_static_info(rec)
            else:
                self._remote_storage.put_update(rec)
        return len(parsed)

    def detach(self, storage: StatsStorage):
        if storage in self._storages:
            self._storages.remove(storage)

    # --------------------------------------------- t-SNE / word2vec views
    def post_tsne(self, session_id: str, points, labels=None):
        """Publish a 2D embedding to the /tsne view (TsneModule.java
        uploadFile/postFile parity). points: (N, 2) array-like or
        [[x, y, label?], ...]; labels: optional per-point labels."""
        out = []
        for i, p in enumerate(points):
            p = list(p)
            if labels is not None:
                out.append([float(p[0]), float(p[1]), str(labels[i])])
            elif len(p) > 2:
                out.append([float(p[0]), float(p[1]), str(p[2])])
            else:
                out.append([float(p[0]), float(p[1])])
        with self._tsne_lock:
            self._tsne_sessions[str(session_id)] = out

    def attach_word_vectors(self, word_vectors):
        """Attach a WordVectors/lookup table for the /word2vec nearest-
        neighbor view (NearestNeighborsQuery.java parity)."""
        self._word_vectors = word_vectors

    def nearest_words(self, word: str, n: int = 10) -> Dict:
        wv = self._word_vectors
        if wv is None:
            return {"error": "no word vectors attached "
                             "(UIServer.attach_word_vectors)"}
        if not word:
            return {"error": "empty query"}
        if hasattr(wv, "has_word") and not wv.has_word(word):
            return {"error": f"'{word}' not in vocabulary"}
        near = wv.words_nearest(word, top_n=n)
        return {"word": word, "nearest": [
            {"word": w, "similarity": float(wv.similarity(word, w))}
            for w in near]}

    # ----------------------------------------------------------- queries
    def session_ids(self):
        out = []
        for s in self._storages:
            out.extend(s.list_session_ids())
        return sorted(set(out))

    def session_data(self, sid: str, after: float) -> Dict:
        static = None
        updates = []
        for s in self._storages:
            for tid in s.list_type_ids(sid):
                for wid in s.list_worker_ids(sid):
                    st = s.get_static_info(sid, tid, wid)
                    if st is not None and static is None:
                        static = {"timestamp": st.timestamp, "data": st.data}
                    for r in s.get_all_updates_after(sid, tid, wid, after):
                        updates.append({"timestamp": r.timestamp,
                                        "data": r.data})
        updates.sort(key=lambda r: r["timestamp"])
        return {"static": static, "updates": updates[:500]}

    def stop(self):
        self._httpd.shutdown()
        self._httpd.server_close()
        if UIServer._instance is self:
            UIServer._instance = None
