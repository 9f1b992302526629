/* Admin SPA over vlog_tpu.api.admin_api.
 * Auth: X-Admin-Secret header on every /api call (the secret lives in
 * sessionStorage only). SSE progress arrives via a streamed fetch
 * because EventSource cannot attach headers.
 */
"use strict";

const $ = (id) => document.getElementById(id);
let secret = sessionStorage.getItem("vlog_admin_secret") || "";
let sseAbort = null;

function toast(msg, isErr) {
  const t = document.createElement("div");
  t.className = "toast" + (isErr ? " error" : "");
  t.textContent = msg;
  document.body.appendChild(t);
  setTimeout(() => t.remove(), 4000);
}

async function api(path, opts = {}) {
  opts.headers = Object.assign({ "X-Admin-Secret": secret }, opts.headers);
  const r = await fetch(path, opts);
  if (r.status === 403) { showLogin("Bad admin secret."); throw new Error("403"); }
  if (!r.ok) {
    let msg = `HTTP ${r.status}`;
    try { msg = (await r.json()).error || msg; } catch (e) { /* not json */ }
    throw new Error(msg);
  }
  return r.status === 204 ? null : r.json();
}

function fmtBytes(n) {
  if (!n) return "—";
  const u = ["B", "KB", "MB", "GB", "TB"];
  let i = 0;
  while (n >= 1024 && i < u.length - 1) { n /= 1024; i++; }
  return `${n.toFixed(i ? 1 : 0)} ${u[i]}`;
}
function fmtDur(s) {
  if (s == null) return "—";
  s = Math.round(s);
  return `${(s / 60) | 0}:${String(s % 60).padStart(2, "0")}`;
}
function fmtAgo(t) {
  if (!t) return "never";
  const d = Date.now() / 1000 - t;
  if (d < 90) return `${Math.round(d)}s ago`;
  if (d < 5400) return `${Math.round(d / 60)}m ago`;
  return `${Math.round(d / 3600)}h ago`;
}
function badge(text) {
  const b = document.createElement("span");
  b.className = `badge ${text}`;
  b.textContent = text;
  return b;
}
function cells(tr, values) {
  for (const v of values) {
    const td = document.createElement("td");
    if (v instanceof Node) td.appendChild(v);
    else td.textContent = v == null ? "—" : String(v);
    tr.appendChild(td);
  }
}
function actionBtn(label, fn, cls) {
  const b = document.createElement("button");
  b.textContent = label;
  if (cls) b.className = cls;
  b.onclick = async () => {
    b.disabled = true;
    try { await fn(); } catch (e) { toast(e.message, true); }
    b.disabled = false;
  };
  return b;
}

/* ------------------------------------------------- login -------------- */

function showLogin(err) {
  $("login").hidden = false;
  $("login-err").textContent = err || "";
  stopSse();
}

$("login-form").addEventListener("submit", async (ev) => {
  ev.preventDefault();
  secret = $("secret").value;
  try {
    await api("/api/settings");
    sessionStorage.setItem("vlog_admin_secret", secret);
    $("login").hidden = true;
    boot();
  } catch (e) { /* showLogin already ran on 403 */ }
});

$("logout").onclick = () => {
  sessionStorage.removeItem("vlog_admin_secret");
  secret = "";
  showLogin("");
};

/* ------------------------------------------------- tabs --------------- */

const loaders = {
  dashboard: loadDashboard, videos: loadVideos, jobs: loadJobs,
  workers: loadWorkers, settings: loadSettings, webhooks: loadWebhooks,
  playlists: loadPlaylists, fields: loadFields, analytics: loadAnalytics,
  queue: loadQueue, audit: loadAudit, storage: loadStorage,
};

function switchTab(name) {
  for (const b of $("tabs").children) b.classList.toggle("active", b.dataset.tab === name);
  for (const s of document.querySelectorAll(".tab")) s.hidden = s.id !== `tab-${name}`;
  location.hash = name;
  loaders[name]();
}
$("tabs").addEventListener("click", (ev) => {
  if (ev.target.dataset.tab) switchTab(ev.target.dataset.tab);
});

/* ------------------------------------------------- dashboard ---------- */

const progressRows = new Map();   // job_id -> tr

async function loadDashboard() {
  const [d, w, jq] = await Promise.all([
    api("/api/analytics/summary"), api("/api/workers"),
    api("/api/jobs?limit=1"),
  ]);
  const vids = d.videos || [];
  const totals = vids.reduce((a, v) => {
    a.sessions += v.sessions; a.watch += v.watch_time_s; a.live += v.live_now;
    return a;
  }, { sessions: 0, watch: 0, live: 0 });
  const online = w.workers.filter((x) => x.online).length;
  // same claimable-state set as the vlog_jobs_queued gauge the worker
  // HPA scales on (api/worker_api.py render)
  const queued = (jq.counts.unclaimed || 0) + (jq.counts.retrying || 0)
    + (jq.counts.expired || 0);
  const stats = [
    [vids.length, "videos with plays"],
    [totals.sessions, "playback sessions"],
    [`${(totals.watch / 3600).toFixed(1)}h`, "watch time"],
    [totals.live, "watching now"],
    [`${online}/${w.workers.length}`, "workers online"],
    [queued, "jobs queued", "queue"],
    [jq.counts.backoff || 0, "in backoff", "queue"],
    [jq.counts.failed || 0, "dead-lettered", "jobs"],
  ];
  const sg = $("stats");
  sg.textContent = "";
  for (const [n, l, tab] of stats) {
    const div = document.createElement("div");
    div.className = "stat";
    div.innerHTML = `<div class="n"></div><div class="l"></div>`;
    div.firstChild.textContent = n;
    div.lastChild.textContent = l;
    if (tab) {
      div.style.cursor = "pointer";
      div.onclick = () => switchTab(tab);
    }
    sg.appendChild(div);
  }
  const tb = $("top-table").tBodies[0];
  tb.textContent = "";
  for (const v of vids.slice(0, 10)) {
    const tr = document.createElement("tr");
    cells(tr, [v.title, v.sessions, v.live_now, `${(v.watch_time_s / 60).toFixed(1)} min`]);
    tb.appendChild(tr);
  }
  loadSlo().catch(() => {});   // SLO panel is additive: never block the tab
  startSse();
}

/* -- SLO burn rates: GET /api/slo (obs/slo.py) -------------------------- */

async function loadSlo() {
  const d = await api("/api/slo");
  const tb = $("slo-table").tBodies[0];
  tb.textContent = "";
  for (const o of d.objectives || []) {
    const tr = document.createElement("tr");
    const fast = o.windows.fast || {}, slow = o.windows.slow || {};
    cells(tr, [
      `${o.name} — ${o.description}`,
      `${(o.target * 100).toFixed(o.target >= 0.999 ? 2 : 1)}%`,
      fast.events ?? 0,
      (fast.burn_rate ?? 0).toFixed(2),
      (slow.burn_rate ?? 0).toFixed(2),
      o.alerting ? "BURNING" : "ok",
    ]);
    if (o.alerting) tr.style.color = "var(--bad, #e05555)";
    tb.appendChild(tr);
  }
  const ex = $("slo-exemplars");
  ex.textContent = "";
  const slowest = (d.exemplars || []).slice(-6).reverse();
  if (!slowest.length) { ex.textContent = "No slow-outlier exemplars."; return; }
  ex.appendChild(document.createTextNode("Slow outliers: "));
  for (const e of slowest) {
    const a = document.createElement("a");
    a.href = "#";
    a.textContent = `${e.objective} job #${e.job_id} (${e.value_s.toFixed(1)}s)`;
    a.onclick = (ev) => { ev.preventDefault(); showTrace(e.job_id); };
    ex.appendChild(a);
    ex.appendChild(document.createTextNode("  "));
  }
}

function renderProgress(ev) {
  const tb = $("progress-table").tBodies[0];
  let tr = progressRows.get(ev.job_id);
  const terminal = ["completed", "dead", "failed"].includes(ev.state);
  if (terminal) {
    if (tr) { tr.remove(); progressRows.delete(ev.job_id); }
    $("progress-empty").hidden = progressRows.size > 0;
    return;
  }
  if (!tr) {
    tr = document.createElement("tr");
    progressRows.set(ev.job_id, tr);
    tb.appendChild(tr);
  }
  tr.textContent = "";
  const bar = document.createElement("div");
  bar.className = "progressbar";
  const fill = document.createElement("div");
  // SSE streams the raw jobs.progress value, already on a 0-100 scale
  fill.style.width = `${Math.round(ev.progress || 0)}%`;
  bar.appendChild(fill);
  const pct = document.createElement("span");
  pct.className = "dim";
  pct.textContent = ` ${Math.round(ev.progress || 0)}% ${ev.current_step || ""}`;
  const cell = document.createElement("div");
  cell.append(bar, pct);
  cells(tr, [`#${ev.job_id}`, `video ${ev.video_id}`, ev.kind, badge(ev.state), cell, ev.worker || "—"]);
  $("progress-empty").hidden = true;
}

async function startSse() {
  if (sseAbort) return;
  sseAbort = new AbortController();
  $("live").textContent = "● live";
  try {
    const r = await fetch("/api/events/progress", {
      headers: { "X-Admin-Secret": secret },
      signal: sseAbort.signal,
    });
    const reader = r.body.getReader();
    const dec = new TextDecoder();
    let buf = "";
    for (;;) {
      const { done, value } = await reader.read();
      if (done) break;
      buf += dec.decode(value, { stream: true });
      let idx;
      while ((idx = buf.indexOf("\n\n")) >= 0) {
        const block = buf.slice(0, idx);
        buf = buf.slice(idx + 2);
        const data = block.split("\n").find((l) => l.startsWith("data: "));
        if (data) {
          try { renderProgress(JSON.parse(data.slice(6))); } catch (e) { /* skip */ }
        }
      }
    }
  } catch (e) { /* aborted or connection lost */ }
  $("live").textContent = "";
  sseAbort = null;
}
function stopSse() {
  if (sseAbort) sseAbort.abort();
}

/* ------------------------------------------------- videos ------------- */

const VID_PAGE = 100;
let vidOffset = 0;

const bulkSel = new Set();        // selected video ids for bulk ops

function syncBulkBar() {
  $("bulk-bar").hidden = bulkSel.size === 0;
  $("bulk-count").textContent = `${bulkSel.size} selected`;
}

async function loadVideos() {
  let extra = $("show-deleted").checked ? "&include_deleted=1" : "";
  const q = $("vids-search").value.trim();
  if (q) extra += `&q=${encodeURIComponent(q)}`;
  const st = $("vids-status").value;
  if (st) extra += `&status=${encodeURIComponent(st)}`;
  const d = await api(
    `/api/videos?limit=${VID_PAGE}&offset=${vidOffset}${extra}`);
  $("vids-page").textContent =
    `${vidOffset + 1}–${Math.min(vidOffset + VID_PAGE, d.total)} of ${d.total}`;
  $("vids-prev").disabled = vidOffset === 0;
  $("vids-next").disabled = vidOffset + VID_PAGE >= d.total;
  const tb = $("videos-table").tBodies[0];
  tb.textContent = "";
  for (const v of d.videos) {
    const tr = document.createElement("tr");
    const acts = document.createElement("div");
    acts.className = "row-actions";
    acts.append(
      actionBtn("detail", async () => openDrawer(v)),
      actionBtn("retranscode", async () => {
        await api(`/api/videos/${v.id}/retranscode`, {
          method: "POST", headers: { "Content-Type": "application/json" },
          body: JSON.stringify({ force: true }),
        });
        toast(`re-transcode queued for #${v.id}`);
      }),
      (() => {
        const target = v.streaming_format === "cmaf" ? "hls_ts" : "cmaf";
        return actionBtn(`→${target}`, async () => {
          await api(`/api/videos/${v.id}/reencode`, {
            method: "POST", headers: { "Content-Type": "application/json" },
            body: JSON.stringify({ streaming_format: target }),
          });
          toast(`re-encode to ${target} queued for #${v.id}`);
        });
      })(),
      v.codec === "h264" && v.streaming_format === "cmaf"
        ? actionBtn("→h265", async () => {
            await api(`/api/videos/${v.id}/reencode`, {
              method: "POST", headers: { "Content-Type": "application/json" },
              body: JSON.stringify({ streaming_format: "cmaf", codec: "h265" }),
            });
            toast(`h265 upgrade queued for #${v.id}`);
          })
        : document.createTextNode(""),
      v.status === "ready"
        ? actionBtn("verify", async () => {
            const r = await api(`/api/videos/${v.id}/verify`, { method: "POST" });
            if (r.ok) toast(`#${v.id} verified: ${r.files_checked} files intact`);
            else toast(`#${v.id} FAILED verification: ${r.problems[0]}`, true);
          })
        : document.createTextNode(""),
      actionBtn("chapters", async () => {
        const d2 = await api(`/api/videos/${v.id}/chapters/detect`, { method: "POST" });
        if (!d2.chapters.length) { toast("no chapters detected"); return; }
        await api(`/api/videos/${v.id}/chapters`, {
          method: "PUT", headers: { "Content-Type": "application/json" },
          body: JSON.stringify({ chapters: d2.chapters }),
        });
        toast(`${d2.chapters.length} chapters saved`);
      }),
      v.deleted_at
        ? actionBtn("restore", async () => { await api(`/api/videos/${v.id}/restore`, { method: "POST" }); loadVideos(); })
        : actionBtn("delete", async () => { await api(`/api/videos/${v.id}`, { method: "DELETE" }); loadVideos(); }),
    );
    const sel = document.createElement("input");
    sel.type = "checkbox";
    sel.checked = bulkSel.has(v.id);
    sel.onchange = () => {
      if (sel.checked) bulkSel.add(v.id); else bulkSel.delete(v.id);
      syncBulkBar();
    };
    cells(tr, [sel, v.id, v.title, badge(v.status), fmtBytes(v.size_bytes), fmtDur(v.duration_s), acts]);
    tb.appendChild(tr);
  }
}

$("show-deleted").addEventListener("change", () => { vidOffset = 0; loadVideos(); });
$("vids-prev").onclick = () => { vidOffset = Math.max(0, vidOffset - VID_PAGE); loadVideos(); };
$("vids-next").onclick = () => { vidOffset += VID_PAGE; loadVideos(); };
let vidsSearchT = null;
$("vids-search").addEventListener("input", () => {
  clearTimeout(vidsSearchT);
  vidsSearchT = setTimeout(() => { vidOffset = 0; loadVideos(); }, 300);
});
$("vids-status").addEventListener("change", () => { vidOffset = 0; loadVideos(); });
$("vids-all").addEventListener("change", (ev) => {
  const boxes = $("videos-table").tBodies[0].querySelectorAll("input[type=checkbox]");
  const ids = [...$("videos-table").tBodies[0].rows].map((r) => parseInt(r.cells[1].textContent, 10));
  boxes.forEach((b, i) => {
    b.checked = ev.target.checked;
    if (ev.target.checked) bulkSel.add(ids[i]); else bulkSel.delete(ids[i]);
  });
  syncBulkBar();
});

async function runBulk(action, body) {
  const d = await api("/api/videos/bulk", {
    method: "POST", headers: { "Content-Type": "application/json" },
    body: JSON.stringify({ action, video_ids: [...bulkSel], ...body }),
  });
  toast(`bulk ${action}: ${d.done.length} done` +
    (d.missing.length ? `, ${d.missing.length} skipped` : ""));
  bulkSel.clear();
  syncBulkBar();
  loadVideos();
}
$("bulk-retranscode").onclick = () => {
  // no force: jobs a worker actively holds are SKIPPED server-side
  // (resetting them would let two workers write one output tree) and
  // reported back in the toast's "skipped" count
  if (confirm(`Retranscode ${bulkSel.size} videos? Actively-running jobs are skipped.`)) {
    runBulk("retranscode", {});
  }
};
$("bulk-delete").onclick = () => {
  if (confirm(`Delete ${bulkSel.size} videos?`)) runBulk("delete", {});
};
$("bulk-clear").onclick = () => { bulkSel.clear(); syncBulkBar(); loadVideos(); };

$("upload-form").addEventListener("submit", (ev) => {
  ev.preventDefault();
  const file = $("up-file").files[0];
  if (!file) return;
  const fd = new FormData();
  fd.append("title", $("up-title").value);
  if ($("up-category").value) fd.append("category", $("up-category").value);
  fd.append("file", file);
  const xhr = new XMLHttpRequest();   // fetch has no upload progress
  xhr.open("POST", "/api/videos");
  xhr.setRequestHeader("X-Admin-Secret", secret);
  $("up-bar").hidden = false;
  xhr.upload.onprogress = (e) => {
    if (e.lengthComputable) $("up-bar").firstChild.style.width = `${(e.loaded / e.total) * 100}%`;
  };
  xhr.onload = () => {
    $("up-bar").hidden = true;
    if (xhr.status === 201) {
      const d = JSON.parse(xhr.responseText);
      $("up-msg").textContent = `Uploaded: video #${d.video.id}, job #${d.job_id}`;
      $("upload-form").reset();
      loadVideos();
    } else {
      let msg = `upload failed: HTTP ${xhr.status}`;
      try { msg = JSON.parse(xhr.responseText).error || msg; } catch (e) { /* */ }
      toast(msg, true);
    }
  };
  xhr.onerror = () => { $("up-bar").hidden = true; toast("upload failed", true); };
  xhr.send(fd);
});

/* ------------------------------------------------- playlists ---------- */

let plDetailId = null;

async function loadPlaylists() {
  const d = await api("/api/playlists");
  const tb = $("playlists-table").tBodies[0];
  tb.textContent = "";
  for (const p of d.playlists) {
    const tr = document.createElement("tr");
    const acts = document.createElement("div");
    acts.className = "row-actions";
    acts.append(
      actionBtn("open", async () => openPlaylist(p.id)),
      actionBtn(p.visibility === "private" ? "publish" : "private",
        async () => {
          await api(`/api/playlists/${p.id}`, {
            method: "PATCH", headers: { "Content-Type": "application/json" },
            body: JSON.stringify({
              visibility: p.visibility === "private" ? "public" : "private" }),
          });
          loadPlaylists();
        }),
      actionBtn("delete", async () => {
        await api(`/api/playlists/${p.id}`, { method: "DELETE" });
        if (plDetailId === p.id) $("pl-detail").hidden = true;
        loadPlaylists();
      }, "danger"),
    );
    cells(tr, [p.id, p.title, p.slug, p.visibility, p.video_count, acts]);
    tb.appendChild(tr);
  }
}

async function openPlaylist(id) {
  plDetailId = id;
  const d = await api(`/api/playlists/${id}`);
  $("pl-detail").hidden = false;
  $("pl-detail-title").textContent = `#${id} ${d.playlist ? d.playlist.title : d.title || ""}`;
  const vids = d.videos || [];
  const tb = $("pl-videos-table").tBodies[0];
  tb.textContent = "";
  vids.forEach((v, idx) => {
    const tr = document.createElement("tr");
    const acts = document.createElement("div");
    acts.className = "row-actions";
    const reorder = async (swapWith) => {
      const order = vids.map((x) => x.id);
      [order[idx], order[swapWith]] = [order[swapWith], order[idx]];
      await api(`/api/playlists/${id}/order`, {
        method: "PUT", headers: { "Content-Type": "application/json" },
        body: JSON.stringify({ video_ids: order }),
      });
      openPlaylist(id);
    };
    acts.append(
      idx > 0 ? actionBtn("↑", () => reorder(idx - 1)) : document.createTextNode(""),
      idx < vids.length - 1 ? actionBtn("↓", () => reorder(idx + 1)) : document.createTextNode(""),
      actionBtn("remove", async () => {
        await api(`/api/playlists/${id}/videos/${v.id}`, { method: "DELETE" });
        openPlaylist(id);
        loadPlaylists();
      }),
    );
    cells(tr, [idx + 1, v.id, v.title, acts]);
    tb.appendChild(tr);
  });
}

$("pl-create").onclick = async () => {
  const title = $("pl-title").value.trim();
  if (!title) return;
  try {
    await api("/api/playlists", {
      method: "POST", headers: { "Content-Type": "application/json" },
      body: JSON.stringify({ title, visibility: $("pl-visibility").value }),
    });
    $("pl-title").value = "";
    loadPlaylists();
  } catch (e) { toast(e.message, true); }
};

$("pl-add").onclick = async () => {
  const vid = parseInt($("pl-add-id").value, 10);
  if (!plDetailId || !vid) return;
  try {
    await api(`/api/playlists/${plDetailId}/videos`, {
      method: "POST", headers: { "Content-Type": "application/json" },
      body: JSON.stringify({ video_id: vid }),
    });
    $("pl-add-id").value = "";
    openPlaylist(plDetailId);
    loadPlaylists();
  } catch (e) { toast(e.message, true); }
};

/* ------------------------------------------------- custom fields ------ */

async function loadFields() {
  const d = await api("/api/custom-fields");
  const tb = $("fields-table").tBodies[0];
  tb.textContent = "";
  for (const f of d.fields) {
    const tr = document.createElement("tr");
    cells(tr, [f.id, f.name, f.label, f.field_type,
      f.required ? "yes" : "no",
      (f.options || []).join(", ") || "—",
      actionBtn("delete", async () => {
        await api(`/api/custom-fields/${f.id}`, { method: "DELETE" });
        loadFields();
      }, "danger")]);
    tb.appendChild(tr);
  }
}

$("cf-create").onclick = async () => {
  const name = $("cf-name").value.trim();
  if (!name) return;
  try {
    await api("/api/custom-fields", {
      method: "POST", headers: { "Content-Type": "application/json" },
      body: JSON.stringify({
        name,
        label: $("cf-label").value || name,
        field_type: $("cf-type").value,
        required: $("cf-required").checked,
        options: $("cf-options").value.split(",").map((s) => s.trim()).filter(Boolean),
      }),
    });
    $("cf-name").value = $("cf-label").value = $("cf-options").value = "";
    loadFields();
  } catch (e) { toast(e.message, true); }
};

/* ------------------------------------------------- analytics ---------- */

function renderBars(el, rows, valueOf, labelOf, titleOf) {
  el.textContent = "";
  const peak = Math.max(1, ...rows.map(valueOf));
  for (const row of rows) {
    const col = document.createElement("div");
    col.className = "bar";
    const fill = document.createElement("div");
    fill.className = "bar-fill";
    fill.style.height = `${Math.round((valueOf(row) / peak) * 100)}%`;
    fill.title = titleOf(row);
    const lbl = document.createElement("div");
    lbl.className = "bar-label";
    lbl.textContent = labelOf(row);
    col.append(fill, lbl);
    el.appendChild(col);
  }
}

async function loadDailyCharts() {
  const days = parseInt($("an-days").value, 10);
  const d = await api(`/api/analytics/daily?days=${days}`);
  // fill gaps so quiet days render as empty slots, not missing bars
  const byDay = new Map(d.days.map((r) => [r.epoch_day, r]));
  const today = Math.floor(Date.now() / 86400000);
  const series = [];
  for (let k = today - days + 1; k <= today; k++) {
    series.push(byDay.get(k) ||
      { epoch_day: k, sessions: 0, watch_time_s: 0 });
  }
  const dayLbl = (r) => {
    const dt = new Date(r.epoch_day * 86400000);
    return `${dt.getUTCMonth() + 1}/${dt.getUTCDate()}`;
  };
  renderBars($("an-daily-sessions"), series, (r) => r.sessions, dayLbl,
    (r) => `${dayLbl(r)}: ${r.sessions} sessions`);
  renderBars($("an-daily-watch"), series, (r) => r.watch_time_s, dayLbl,
    (r) => `${dayLbl(r)}: ${(r.watch_time_s / 3600).toFixed(1)}h watched`);
}

$("an-days").addEventListener("change", loadDailyCharts);

async function loadAnalytics() {
  loadDailyCharts();
  const m = await api("/api/analytics/sessions/months");
  const wrap = $("an-months");
  wrap.textContent = "";
  const months = m.months.slice().reverse();   // oldest -> newest
  const peak = Math.max(1, ...months.map((x) => x.sessions));
  for (const row of months) {
    const col = document.createElement("div");
    col.className = "bar";
    const fill = document.createElement("div");
    fill.className = "bar-fill";
    fill.style.height = `${Math.round((row.sessions / peak) * 100)}%`;
    fill.title = `${row.month}: ${row.sessions} sessions, ` +
      `${(row.watch_time_s / 3600).toFixed(1)}h watched`;
    const lbl = document.createElement("div");
    lbl.className = "bar-label";
    lbl.textContent = row.month.slice(2);
    col.append(fill, lbl);
    wrap.appendChild(col);
  }
  const d = await api("/api/analytics/summary");
  const tb = $("an-table").tBodies[0];
  tb.textContent = "";
  for (const v of d.videos.slice(0, 50)) {
    const tr = document.createElement("tr");
    cells(tr, [v.title, v.sessions, v.live_now,
      `${(v.watch_time_s / 60).toFixed(1)} min`]);
    tb.appendChild(tr);
  }
}

$("an-prune").onclick = async () => {
  try {
    const r = await api("/api/analytics/sessions/prune", { method: "POST" });
    $("an-prune-msg").textContent =
      `closed ${r.closed} stale, pruned ${r.pruned} old sessions`;
    loadAnalytics();
  } catch (e) { toast(e.message, true); }
};

/* ------------------------------------------------- video drawer ------- */

let drawerVideoId = null;

async function refreshThumb(id) {
  // <img src> cannot carry the X-Admin-Secret header: fetch -> blob URL
  const img = $("dr-thumb");
  if (img.dataset.blob) URL.revokeObjectURL(img.dataset.blob);
  img.removeAttribute("src");
  try {
    const r = await fetch(`/api/videos/${id}/thumbnail`, {
      headers: { "X-Admin-Secret": secret } });
    if (!r.ok) return;
    const url = URL.createObjectURL(await r.blob());
    img.dataset.blob = url;
    img.src = url;
  } catch (e) { /* no thumbnail yet */ }
}

async function openDrawer(v) {
  drawerVideoId = v.id;
  $("drawer").hidden = false;
  $("dr-title").textContent = `#${v.id} ${v.title}`;
  refreshThumb(v.id);
  loadDrawerChapters(v.id);
  $("dr-sprites").textContent = "";
  revokeSpriteBlobs();
  $("dr-sp-msg").textContent = "";
  $("dr-ch-msg").textContent = "";
  $("dr-tr-msg").textContent = "";
  try {
    const tr = await api(`/api/videos/${v.id}/transcript`);
    $("dr-transcript").value = tr.transcript ? tr.transcript.text || "" : "";
  } catch (e) { $("dr-transcript").value = ""; }
  // custom field editor: one input per defined field, typed
  const defs = (await api("/api/custom-fields")).fields;
  const valRows = (await api(`/api/videos/${v.id}/custom-fields`)).values || [];
  const vals = {};
  for (const r of valRows) {
    if (r.value != null) {
      try { vals[r.name] = JSON.parse(r.value); }
      catch (e) { vals[r.name] = r.value; }
    }
  }
  const wrap = $("dr-fields");
  wrap.textContent = "";
  for (const f of defs) {
    const row = document.createElement("div");
    row.className = "formrow";
    const lbl = document.createElement("label");
    lbl.className = "dim";
    lbl.textContent = f.label + (f.required ? " *" : "");
    lbl.style.minWidth = "12em";
    let input;
    if (f.field_type === "select") {
      input = document.createElement("select");
      for (const o of [""].concat(f.options || [])) {
        const opt = document.createElement("option");
        opt.value = o; opt.textContent = o || "—";
        input.appendChild(opt);
      }
      input.value = vals[f.name] != null ? String(vals[f.name]) : "";
    } else if (f.field_type === "boolean") {
      input = document.createElement("input");
      input.type = "checkbox";
      input.checked = !!vals[f.name];
    } else {
      input = document.createElement("input");
      input.type = f.field_type === "number" ? "number"
        : f.field_type === "date" ? "date" : "text";
      input.value = vals[f.name] != null ? String(vals[f.name]) : "";
    }
    input.dataset.field = f.name;
    input.dataset.ftype = f.field_type;
    row.append(lbl, input);
    wrap.appendChild(row);
  }
}

$("dr-close").onclick = () => {
  $("drawer").hidden = true;
  drawerVideoId = null;
  revokeSpriteBlobs();
};

$("dr-thumb-grab").onclick = async () => {
  const t = parseFloat($("dr-thumb-time").value || "0");
  try {
    await api(`/api/videos/${drawerVideoId}/thumbnail/from-time`, {
      method: "POST", headers: { "Content-Type": "application/json" },
      body: JSON.stringify({ time_s: t }),
    });
    toast("thumbnail regenerated");
    refreshThumb(drawerVideoId);
  } catch (e) { toast(e.message, true); }
};

$("dr-thumb-upload").onclick = async () => {
  const file = $("dr-thumb-file").files[0];
  if (!file) return;
  try {
    const r = await fetch(`/api/videos/${drawerVideoId}/thumbnail`, {
      method: "PUT",
      headers: { "X-Admin-Secret": secret, "Content-Type": "image/jpeg" },
      body: file,
    });
    if (!r.ok) throw new Error((await r.json()).error || `HTTP ${r.status}`);
    toast("thumbnail uploaded");
    refreshThumb(drawerVideoId);
  } catch (e) { toast(e.message, true); }
};

$("dr-tr-save").onclick = async () => {
  try {
    await api(`/api/videos/${drawerVideoId}/transcript`, {
      method: "PUT", headers: { "Content-Type": "application/json" },
      body: JSON.stringify({ text: $("dr-transcript").value }),
    });
    $("dr-tr-msg").textContent = "saved";
  } catch (e) { toast(e.message, true); }
};

$("dr-tr-delete").onclick = async () => {
  try {
    await api(`/api/videos/${drawerVideoId}/transcript`, { method: "DELETE" });
    $("dr-transcript").value = "";
    $("dr-tr-msg").textContent = "deleted; transcription requeued on next run";
  } catch (e) { toast(e.message, true); }
};

$("dr-cf-save").onclick = async () => {
  const values = {};
  for (const input of $("dr-fields").querySelectorAll("[data-field]")) {
    const t = input.dataset.ftype;
    // null is part of the contract: it DELETES the stored value
    // (omitting the key would leave a cleared field resurrected)
    if (t === "boolean") values[input.dataset.field] = input.checked;
    else if (t === "number") values[input.dataset.field] = input.value === "" ? null : Number(input.value);
    else values[input.dataset.field] = input.value === "" ? null : input.value;
  }
  try {
    // the PUT body IS the {field: value} map (catalog.py contract)
    await api(`/api/videos/${drawerVideoId}/custom-fields`, {
      method: "PUT", headers: { "Content-Type": "application/json" },
      body: JSON.stringify(values),
    });
    $("dr-cf-msg").textContent = "saved";
  } catch (e) { toast(e.message, true); }
};

/* ------------------------------------------------- jobs --------------- */

function failureHistory(failures) {
  // Compact per-attempt post-mortem: "N× class" badges up front, the
  // full attempt/worker/error list behind a <details> fold.
  if (!failures || failures.length === 0) {
    const s = document.createElement("span");
    s.className = "dim";
    s.textContent = "—";
    return s;
  }
  const byClass = {};
  for (const f of failures) byClass[f.failure_class] = (byClass[f.failure_class] || 0) + 1;
  const det = document.createElement("details");
  const sum = document.createElement("summary");
  for (const [cls, n] of Object.entries(byClass).sort()) {
    sum.appendChild(badge(`${cls}: ${n}`));
  }
  det.appendChild(sum);
  const ul = document.createElement("ul");
  ul.style.margin = "4px 0 0 0";
  for (const f of failures) {
    const li = document.createElement("li");
    li.className = "dim";
    li.style.fontSize = "11px";
    li.textContent = `attempt ${f.attempt} · ${f.failure_class}`
      + ` · ${f.worker || "?"} · ${(f.error || "").slice(0, 160)}`;
    li.title = f.error || "";
    ul.appendChild(li);
  }
  det.appendChild(ul);
  return det;
}

async function loadJobs() {
  const d = await api("/api/jobs/failed");
  const tb = $("failed-table").tBodies[0];
  tb.textContent = "";
  $("failed-empty").hidden = d.jobs.length > 0;
  for (const jb of d.jobs) {
    const tr = document.createElement("tr");
    const err = document.createElement("span");
    err.className = "dim";
    err.textContent = (jb.error || "").slice(0, 120);
    err.title = jb.error || "";
    cells(tr, [`#${jb.id}`, jb.title, jb.kind, jb.attempt, err,
      failureHistory(jb.failures),
      actionBtn("requeue", async () => { await api(`/api/jobs/${jb.id}/requeue`, { method: "POST" }); loadJobs(); })]);
    tb.appendChild(tr);
  }
}

/* ------------------------------------------------- workers ------------ */

async function loadWorkers() {
  const d = await api("/api/workers");
  const tb = $("workers-table").tBodies[0];
  tb.textContent = "";
  for (const w of d.workers) {
    const tr = document.createElement("tr");
    const acts = document.createElement("div");
    acts.className = "row-actions";
    const cmd = (c) => actionBtn(c, async () => {
      await api(`/api/workers/${encodeURIComponent(w.name)}/command`, {
        method: "POST", headers: { "Content-Type": "application/json" },
        body: JSON.stringify({ command: c }),
      });
      toast(`${c} queued for ${w.name}; polling result…`);
      setTimeout(async () => {
        const r = await api(`/api/workers/${encodeURIComponent(w.name)}/commands`);
        $("cmd-out").hidden = false;
        $("cmd-pre").textContent = JSON.stringify(r.commands.slice(0, 3), null, 2);
      }, 3000);
    });
    acts.append(cmd("ping"), cmd("stats"), cmd("get_logs"),
      cmd("get_metrics"), cmd("restart"), cmd("stop"),
      // grace-budgeted evacuation: stop claiming, finish/checkpoint
      // in-flight work, release claims, exit (worker/drain.py)
      actionBtn("drain", async () => {
        await api(`/api/workers/${encodeURIComponent(w.name)}/drain`, { method: "POST" });
        toast(`drain queued for ${w.name}; worker picks it up on its next heartbeat`);
        setTimeout(loadWorkers, 3000);
      }),
      actionBtn("revoke", async () => {
        await api(`/api/workers/${encodeURIComponent(w.name)}/revoke`, { method: "POST" });
        toast(`revoked ${w.name}`);
        loadWorkers();
      }));
    cells(tr, [w.name,
      badge(w.status === "revoked" ? "revoked"
        : (w.status === "draining" && w.online ? "draining"
          : (w.online ? "online" : "offline"))),
      w.accelerator, fmtAgo(w.last_heartbeat_at),
      w.capabilities.running_jobs != null ? String(w.capabilities.running_jobs) : "—",
      acts]);
    tb.appendChild(tr);
  }
}

/* ------------------------------------------------- storage ------------ */

function renderGcReport(report) {
  const tb = $("st-gc-table").tBodies[0];
  tb.textContent = "";
  const entries = (report && report.removed) || [];
  for (const e of entries) {
    const tr = document.createElement("tr");
    cells(tr, [e.path, badge(e.kind), fmtBytes(e.bytes)]);
    tb.appendChild(tr);
  }
  $("st-gc-empty").hidden = entries.length > 0;
  $("st-gc-empty").textContent = report
    ? "Sweep removed nothing." : "No sweep yet.";
  if (report) {
    $("st-gc-msg").textContent =
      `${report.dry_run ? "[dry run] " : ""}${report.removed_count} reclaimed ` +
      `(${fmtBytes(report.bytes_reclaimed)}), ${report.kept_live.length} kept live, ` +
      `${report.errors.length} errors`;
  }
}

async function loadStorage() {
  const s = await api("/api/storage/status");
  const tb = $("st-volumes").tBodies[0];
  tb.textContent = "";
  for (const [name, v] of Object.entries(s.volumes)) {
    const tr = document.createElement("tr");
    cells(tr, [name, v.path, fmtBytes(v.free_bytes), fmtBytes(v.min_free_bytes),
      badge(v.pressure ? "pressure" : "ok")]);
    tb.appendChild(tr);
  }
  const g = await api("/api/storage/gc");
  renderGcReport(g.last_report);
  const t = g.totals;
  $("st-totals").textContent =
    `lifetime: ${t.runs} sweeps, ${t.files_removed} removed, ` +
    `${fmtBytes(t.bytes_reclaimed)} reclaimed, ${t.errors} errors`;
  await loadDeliveryStats();
}

async function loadDeliveryStats() {
  const d = await api("/api/delivery/stats");
  const tb = $("dl-stats").tBodies[0];
  tb.textContent = "";
  $("dl-empty").hidden = d.plane_count > 0;
  $("dl-stats").hidden = d.plane_count === 0;
  $("dl-tier").hidden = d.plane_count === 0;
  if (d.plane_count === 0) {
    $("dl-summary").textContent = "";
    $("dl-ring").textContent = "";
    $("dl-fabric-summary").textContent = "";
    $("dl-fabric").hidden = true;
    $("dl-heat").hidden = true;
    $("dl-fabric-empty").hidden = true;
    return;
  }
  const s = d.totals;
  const served = s.hits + s.misses;
  const rate = served ? ((100 * s.hits) / served).toFixed(1) + "%" : "—";
  const tr = document.createElement("tr");
  cells(tr, [String(s.hits), String(s.misses), rate,
    `${fmtBytes(s.cache_bytes)} / ${fmtBytes(s.cache_budget_bytes)}`,
    String(s.cache_entries), String(s.single_flight_collapses),
    String(s.evictions), String(s.shed), String(s.state_hits),
    String(s.state_misses)]);
  tb.appendChild(tr);
  const tt = $("dl-tier").tBodies[0];
  tt.textContent = "";
  const t2 = document.createElement("tr");
  cells(t2, [String(s.l2_hits), String(s.l2_misses), String(s.l2_corrupt),
    String(s.l2_stores), String(s.l2_evictions),
    `${fmtBytes(s.l2_bytes)} / ${fmtBytes(s.l2_budget_bytes)}`,
    String(s.peer_fills), String(s.peer_errors), String(s.sendfile),
    String(s.prewarm_runs), String(s.prewarm_segments),
    String(s.prewarm_errors)]);
  tt.appendChild(t2);
  const ring = d.ring;
  $("dl-ring").textContent = ring && ring.enabled
    ? `ring: ${ring.peers.length} peers [${ring.peers.join(", ")}]` +
      (ring.self ? `, self=${ring.self}` : ", self not in ring")
    : "ring: disabled (single-origin; set VLOG_DELIVERY_PEERS to enable peer fill)";
  $("dl-summary").textContent =
    `${d.plane_count} plane(s), ${s.invalidations} invalidations, ` +
    `${s.inflight_reads}/${s.max_inflight_reads} reads in flight`;
  renderFabric(d.fabric);
}

function renderFabric(f) {
  const havePeers = f && f.membership && f.membership.peers.length > 0;
  $("dl-fabric").hidden = !havePeers;
  $("dl-heat").hidden = !havePeers;
  $("dl-fabric-empty").hidden = havePeers;
  if (!havePeers) { $("dl-fabric-summary").textContent = ""; return; }
  const hedgeRate = f.hedges
    ? ` (${((100 * f.hedge_wins) / f.hedges).toFixed(0)}% won)` : "";
  $("dl-fabric-summary").textContent =
    `ring v${f.ring_version}, gossip every ${f.gossip_interval_s}s, ` +
    `hedge budget ${f.hedge_delay_ms == null ? "off" : f.hedge_delay_ms + " ms"}, ` +
    `${f.hedges} hedges${hedgeRate}, ${f.coalesced_fills} coalesced fills, ` +
    `${f.peer_quarantines} quarantines`;
  const tb = $("dl-fabric").tBodies[0];
  tb.textContent = "";
  for (const p of f.membership.peers) {
    const tr = document.createElement("tr");
    cells(tr, [p.url, badge(p.state),
      String(p.fails), `${p.state_age_s}s`,
      p.last_ok_age_s == null ? "never" : `${p.last_ok_age_s}s ago`]);
    tb.appendChild(tr);
  }
  const th = $("dl-heat").tBodies[0];
  th.textContent = "";
  for (const h of f.heat_top) {
    const tr = document.createElement("tr");
    cells(tr, [h.slug, String(h.heat)]);
    th.appendChild(tr);
  }
  $("dl-heat").hidden = f.heat_top.length === 0;
}

$("dl-invalidate").onclick = async () => {
  const slug = $("dl-slug").value.trim();
  const body = slug ? { slug } : { all: true };
  try {
    const r = await api("/api/delivery/invalidate", {
      method: "POST", headers: { "Content-Type": "application/json" },
      body: JSON.stringify(body),
    });
    $("dl-msg").textContent =
      `evicted ${r.entries_dropped} entries (${r.target})`;
    loadDeliveryStats();
  } catch (e) { toast(e.message, true); }
};

$("st-gc-run").onclick = async () => {
  const body = { dry_run: $("st-dry").checked };
  const age = $("st-temp-age").value.trim();
  if (age) body.temp_max_age_s = parseFloat(age);
  try {
    const r = await api("/api/storage/gc", {
      method: "POST", headers: { "Content-Type": "application/json" },
      body: JSON.stringify(body),
    });
    renderGcReport(r.report);
  } catch (e) { toast(e.message, true); }
};

/* ------------------------------------------------- settings ----------- */

async function loadSettings() {
  const d = await api("/api/settings");   // shape: {settings: {key: value}}
  const tb = $("settings-table").tBodies[0];
  tb.textContent = "";
  for (const [key, value] of Object.entries(d.settings)) {
    const tr = document.createElement("tr");
    cells(tr, [key, JSON.stringify(value),
      actionBtn("delete", async () => { await api(`/api/settings/${encodeURIComponent(key)}`, { method: "DELETE" }); loadSettings(); })]);
    tb.appendChild(tr);
  }
}

$("set-save").onclick = async () => {
  const key = $("set-key").value.trim();
  if (!key) return;
  let value = $("set-val").value;
  try { value = JSON.parse(value); } catch (e) { /* keep as string */ }
  try {
    await api(`/api/settings/${encodeURIComponent(key)}`, {
      method: "PUT", headers: { "Content-Type": "application/json" },
      body: JSON.stringify({ value }),
    });
    $("set-key").value = $("set-val").value = "";
    loadSettings();
  } catch (e) { toast(e.message, true); }
};

/* ------------------------------------------------- webhooks ----------- */

async function loadWebhooks() {
  const d = await api("/api/webhooks");
  const tb = $("webhooks-table").tBodies[0];
  tb.textContent = "";
  for (const w of d.webhooks) {
    const tr = document.createElement("tr");
    const acts = document.createElement("div");
    acts.className = "row-actions";
    acts.append(
      actionBtn("history", async () => {
        const h = await api(`/api/webhooks/${w.id}/deliveries`);
        const tb2 = $("wh-hist-table").tBodies[0];
        tb2.textContent = "";
        $("wh-hist").hidden = false;
        $("wh-hist").dataset.webhookId = String(w.id);
        $("wh-hist-title").textContent = `Deliveries for #${w.id} ${w.url}`;
        for (const dl of h.deliveries) {
          const tr2 = document.createElement("tr");
          cells(tr2, [dl.event, badge(dl.status), dl.attempts,
            dl.response_code ?? "—", fmtAgo(dl.created_at),
            dl.delivered_at ? fmtAgo(dl.delivered_at) : "—"]);
          tb2.appendChild(tr2);
        }
        $("wh-hist-empty").hidden = h.deliveries.length > 0;
      }),
      actionBtn("delete", async () => {
        await api(`/api/webhooks/${w.id}`, { method: "DELETE" });
        if ($("wh-hist").dataset.webhookId === String(w.id)) {
          $("wh-hist").hidden = true;   // panel showed THIS webhook
        }
        loadWebhooks();
      }));
    cells(tr, [w.id, w.url, w.events.join(", ") || "all",
      w.active ? "yes" : "no", acts]);
    tb.appendChild(tr);
  }
}

$("wh-create").onclick = async () => {
  const url = $("wh-url").value.trim();
  if (!url) return;
  try {
    await api("/api/webhooks", {
      method: "POST", headers: { "Content-Type": "application/json" },
      body: JSON.stringify({
        url,
        events: $("wh-events").value.split(",").map((s) => s.trim()).filter(Boolean),
        secret: $("wh-secret").value || null,
      }),
    });
    $("wh-url").value = $("wh-events").value = $("wh-secret").value = "";
    loadWebhooks();
  } catch (e) { toast(e.message, true); }
};

/* ------------------------------------------------- queue -------------- */

let qCursor = null;     // keyset position of the next page (null = first)
let qLoading = false;   // double-click guard: one in-flight page fetch

async function loadQueue(more) {
  if (qLoading) return;
  qLoading = true;
  try {
    await loadQueuePage(more);
  } finally {
    qLoading = false;
  }
}

async function loadQueuePage(more) {
  const st = $("q-state").value;
  const tenant = $("q-tenant").value.trim();
  if (!more) {
    qCursor = null;
    loadScaleHint();   // fire-and-forget; the hint is advisory
  }
  const params = new URLSearchParams();
  if (st) params.set("state", st);
  if (tenant) params.set("tenant", tenant);
  if (qCursor) params.set("cursor", qCursor);
  const qs = params.toString();
  const d = await api(`/api/jobs${qs ? `?${qs}` : ""}`);
  if (d.counts) {   // only the first (cursorless) page carries counts
    const pills = $("q-counts");
    pills.textContent = "";
    for (const [state, n] of Object.entries(d.counts).sort()) {
      const b = badge(`${state}: ${n}`);
      b.style.cursor = "pointer";
      b.onclick = () => { $("q-state").value = state; loadQueue(); };
      pills.appendChild(b);
    }
  }
  const tb = $("queue-table").tBodies[0];
  if (!more) tb.textContent = "";
  for (const jb of d.jobs) {
    const tr = document.createElement("tr");
    // jobs.progress is stored 0-100 (claims.update_progress clamp)
    const prog = jb.progress != null
      ? `${Math.round(jb.progress)}%` : "—";
    const state = badge(jb.state);
    if (jb.state === "backoff" && jb.next_retry_at) {
      state.title = `retry due in ${Math.max(0,
        Math.round(jb.next_retry_at - Date.now() / 1000))}s`;
    }
    cells(tr, [`#${jb.id}`, jb.title, jb.tenant || "default", jb.kind, state,
      jb.attempt, prog, jb.current_step || "—", jb.claimed_by || "—",
      fmtAgo(jb.updated_at),
      actionBtn("trace", async () => showTrace(jb.id))]);
    tb.appendChild(tr);
  }
  $("queue-empty").hidden = tb.rows.length > 0;
  qCursor = d.next_cursor;
  $("q-more").hidden = !qCursor;
}

async function loadScaleHint() {
  try {
    const s = await api("/api/fleet/scale-hint");
    const sign = s.scale_hint > 0 ? `+${s.scale_hint}` : `${s.scale_hint}`;
    $("q-scale-hint").textContent =
      `scale hint: ${sign} workers (${s.queued} queued / ` +
      `${s.workers_online} online, wait p99 ${s.queue_wait_p99_s.toFixed(1)}s` +
      `${s.brownout_open ? ", BROWNOUT" : ""})`;
  } catch (e) {
    $("q-scale-hint").textContent = "";
  }
}
$("q-refresh").onclick = () => loadQueue();
$("q-more").onclick = () => loadQueue(true);
$("q-state").addEventListener("change", () => loadQueue());
$("q-tenant").addEventListener("change", () => loadQueue());
$("trace-close").onclick = () => { $("trace-panel").hidden = true; };

/* -- trace waterfall: GET /api/jobs/{id}/trace -> horizontal timeline -- */

function flattenSpans(nodes, depth, out) {
  for (const n of nodes) {
    out.push([n, depth]);
    flattenSpans(n.children || [], depth + 1, out);
  }
  return out;
}

function fmtSecs(s) {
  if (s == null) return "";
  if (s < 0.001) return "<1ms";
  if (s < 1) return `${Math.round(s * 1000)}ms`;
  if (s < 120) return `${s.toFixed(s < 10 ? 2 : 1)}s`;
  return `${(s / 60).toFixed(1)}m`;
}

async function showTrace(jobId) {
  const d = await api(`/api/jobs/${jobId}/trace`);
  const flat = flattenSpans(d.spans || [], 0, []);
  $("trace-panel").hidden = false;
  $("trace-title").textContent =
    `Trace for job #${jobId}` + (d.trace_id ? ` · ${d.trace_id}` : "");
  const wrap = $("trace-rows");
  wrap.textContent = "";
  $("trace-empty").hidden = flat.length > 0;
  if (!flat.length) return;
  // absolute axis: earliest span start -> latest known end
  const t0 = Math.min(...flat.map(([n]) => n.started_at));
  const t1 = Math.max(...flat.map(([n]) => n.started_at + (n.duration_s || 0)));
  const total = Math.max(t1 - t0, 1e-6);
  for (const [n, depth] of flat) {
    const row = document.createElement("div");
    row.className = "wf-row";
    const label = document.createElement("div");
    label.className = "wf-label";
    label.style.paddingLeft = `${depth * 14}px`;
    label.textContent = n.name;
    label.title = `${n.name} (${n.origin})\n` +
      JSON.stringify(n.attrs, null, 1);
    const track = document.createElement("div");
    track.className = "wf-track";
    const bar = document.createElement("div");
    bar.className = "wf-bar" + (n.status === "error" ? " error" : "") +
      (n.attrs && n.attrs.synthetic ? " synthetic" : "");
    const left = ((n.started_at - t0) / total) * 100;
    const width = ((n.duration_s || 0) / total) * 100;
    bar.style.left = `${Math.min(left, 99.5).toFixed(2)}%`;
    bar.style.width = `${Math.max(width, 0.5).toFixed(2)}%`;
    track.appendChild(bar);
    const dur = document.createElement("div");
    dur.className = "wf-dur dim";
    dur.textContent = n.duration_s != null ? fmtSecs(n.duration_s) : "·";
    row.append(label, track, dur);
    wrap.appendChild(row);
  }
}

/* ------------------------------------------------- audit -------------- */

async function loadAudit() {
  const action = $("au-action").value.trim();
  const q = $("au-q").value.trim();
  const params = new URLSearchParams();
  if (action) params.set("action", action);
  if (q) params.set("q", q);
  const d = await api(`/api/audit?${params}`);
  const tb = $("audit-table").tBodies[0];
  tb.textContent = "";
  $("audit-empty").hidden = d.entries.length > 0;
  for (const e of d.entries.slice(0, 300)) {
    const tr = document.createElement("tr");
    const { ts, action: act, ...rest } = e;
    const det = document.createElement("code");
    det.textContent = JSON.stringify(rest);
    det.style.fontSize = "11px";
    cells(tr, [new Date(ts * 1000).toLocaleString(), badge(act), det]);
    tb.appendChild(tr);
  }
}
$("au-refresh").onclick = loadAudit;

/* ------------------------------------------------- drawer: chapters --- */

let drawerChapters = [];

function renderChapters() {
  const tb = $("dr-chapters").tBodies[0];
  tb.textContent = "";
  drawerChapters.sort((a, b) => a.start_s - b.start_s);
  drawerChapters.forEach((ch, i) => {
    const tr = document.createElement("tr");
    cells(tr, [fmtDur(ch.start_s), ch.title,
      actionBtn("remove", async () => {
        drawerChapters.splice(i, 1);
        renderChapters();
      })]);
    tb.appendChild(tr);
  });
}

async function loadDrawerChapters(id) {
  try {
    const d = await api(`/api/videos/${id}/chapters`);
    drawerChapters = d.chapters || [];
  } catch (e) { drawerChapters = []; }
  renderChapters();
}

$("dr-ch-add").onclick = () => {
  const start = parseFloat($("dr-ch-start").value);
  const title = $("dr-ch-title").value.trim();
  if (isNaN(start) || !title) { toast("need seconds + title", true); return; }
  drawerChapters.push({ start_s: start, title });
  $("dr-ch-start").value = $("dr-ch-title").value = "";
  renderChapters();
};
$("dr-ch-save").onclick = async () => {
  try {
    await api(`/api/videos/${drawerVideoId}/chapters`, {
      method: "PUT", headers: { "Content-Type": "application/json" },
      body: JSON.stringify({ chapters: drawerChapters }),
    });
    $("dr-ch-msg").textContent = `${drawerChapters.length} chapters saved`;
  } catch (e) { toast(e.message, true); }
};
$("dr-ch-detect").onclick = async () => {
  try {
    const d = await api(`/api/videos/${drawerVideoId}/chapters/detect`,
      { method: "POST" });
    drawerChapters = d.chapters || [];
    renderChapters();
    $("dr-ch-msg").textContent =
      `${drawerChapters.length} detected (unsaved)`;
  } catch (e) { toast(e.message, true); }
};

/* ------------------------------------------------- drawer: sprites ---- */

let spriteBlobUrls = [];        // revoked on re-load / drawer close

function revokeSpriteBlobs() {
  for (const u of spriteBlobUrls.splice(0)) URL.revokeObjectURL(u);
}

$("dr-sp-load").onclick = async () => {
  const wrap = $("dr-sprites");
  wrap.textContent = "";
  revokeSpriteBlobs();
  $("dr-sp-msg").textContent = "";
  let d;
  try {
    d = await api(`/api/videos/${drawerVideoId}/sprites`);
  } catch (e) {
    $("dr-sp-msg").textContent = e.message;
    return;
  }
  // one blob URL per sheet (admin plane needs the auth header)
  const sheets = new Map();
  for (const cue of d.cues.slice(0, 60)) {
    if (!sheets.has(cue.sheet)) {
      const r = await fetch(
        `/api/videos/${drawerVideoId}/sprites/${cue.sheet}`,
        { headers: { "X-Admin-Secret": secret } });
      if (!r.ok) continue;
      const u = URL.createObjectURL(await r.blob());
      spriteBlobUrls.push(u);
      sheets.set(cue.sheet, u);
    }
    const tile = document.createElement("div");
    tile.className = "sprite-tile";
    tile.style.width = `${cue.w}px`;
    tile.style.height = `${cue.h}px`;
    tile.style.background =
      `url(${sheets.get(cue.sheet)}) -${cue.x}px -${cue.y}px`;
    tile.title = fmtDur(cue.start_s);
    wrap.appendChild(tile);
  }
  $("dr-sp-msg").textContent = `${d.cues.length} tiles`;
};

/* ------------------------------------------------- boot --------------- */

async function boot() {
  const tab = (location.hash || "#dashboard").slice(1);
  switchTab(loaders[tab] ? tab : "dashboard");
}

(async () => {
  if (!secret) { showLogin(""); return; }
  try {
    await api("/api/settings");
    boot();
  } catch (e) { /* 403 -> login shown */ }
})();
