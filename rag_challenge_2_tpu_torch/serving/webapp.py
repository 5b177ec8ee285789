"""Web QA frontend.

Role of the reference's Streamlit app (reference app_jinpan_qa.py, 3058
LoC): a browser UI over the QA stack with a configuration panel (retrieval
method, max_hops/neighbor_k, HyDE/multi-query toggles, rerank sample size,
year filter, multi-turn window — reference :1528-1857), rich result display
(answer, reasoning, references, all retrieved chunks with scores and
hit-count/method tags, expansion details, algorithm-contribution stats,
timing — reference :466-1477), a cited-page viewer (reference :307-352
renders PDF page images; here the indexed page text), a categorized
question bank, and the evaluation-results analysis flow — run a batch
through the pipeline, LLM-judge each answer, browse per-question
score/reasoning plus aggregate stats (reference :2846+).

Streamlit is not available in this image, so the app is a dependency-free
``http.server`` JSON API + a single-page HTML client.  All retrieval runs
on the card (kernels K1-K3) through the same QuestionsProcessor as the
CLI.  Port of ``rag_challenge_2_tpu/serving/webapp.py``: the same
endpoints and payloads; replies carry Python numbers, lists and strings
only, as the processor builds them.
"""

from __future__ import annotations

import dataclasses
import json
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, List, Optional
from urllib.parse import parse_qs, urlparse

from ..eval.judge import JudgeHarness
from ..qa.processor import QuestionsProcessor

_PAGE = """<!DOCTYPE html>
<html lang="zh">
<head>
<meta charset="utf-8"><title>金盘科技年报问答 (GPU)</title>
<style>
 body { font-family: system-ui, "PingFang SC", sans-serif; margin: 0; display: flex; }
 #side { width: 320px; padding: 16px; background: #f5f6f8; height: 100vh;
         overflow-y: auto; box-sizing: border-box; }
 #main { flex: 1; padding: 24px; max-width: 980px; }
 label { display:block; margin: 10px 0 2px; font-size: 13px; color: #444; }
 select, input[type=number], input[type=text] { width: 100%; padding: 4px; }
 .row { display:flex; gap:8px; } .row > div { flex:1; }
 #q { width: 100%; padding: 10px; font-size: 16px; }
 button { margin-top: 10px; padding: 8px 18px; font-size: 15px; cursor: pointer; }
 .tabs { display:flex; gap:4px; margin-top: 18px; flex-wrap: wrap; }
 .tabs button, .modes button { margin:0; padding: 6px 10px; font-size: 13px; }
 .tabs button.on, .modes button.on { background:#2458d6; color:white; }
 .panel { border:1px solid #ddd; padding:14px; margin-top:-1px; white-space:pre-wrap;
          font-size:14px; max-height: 60vh; overflow-y:auto; }
 .answer { font-size: 20px; margin: 16px 0; padding: 14px; background:#eef4ff;
           border-radius: 8px; }
 table { border-collapse: collapse; font-size: 13px; width:100%; }
 td, th { border:1px solid #ccc; padding:4px 6px; text-align:left; vertical-align:top; }
 .hist { color:#666; font-size:13px; margin:4px 0; }
 .cat { font-weight:600; margin-top:8px; font-size:13px; }
 .pageview { position:fixed; right:0; top:0; width:420px; height:100vh; background:#fff;
             border-left:2px solid #2458d6; padding:16px; overflow-y:auto; box-sizing:border-box;
             white-space:pre-wrap; font-size:13px; display:none; z-index:5; }
 .score-ok { color:#0a7d32; font-weight:600; } .score-bad { color:#c0262d; font-weight:600; }
 .modes { display:flex; gap:4px; margin-bottom:14px; }
 textarea { width:100%; height:120px; font-size:13px; }
</style>
</head>
<body>
<div id="side">
 <h3>检索配置</h3>
 <label>检索方法</label>
 <select id="method">
  <option value="basic">Basic</option>
  <option value="ssg">SSG 图遍历</option>
  <option value="triangulation">Triangulation</option>
  <option value="hybrid_expansion">Hybrid Expansion</option>
 </select>
 <div class="row">
  <div><label>max_hops</label><input id="max_hops" type="number" value="4"></div>
  <div><label>neighbor_k</label><input id="neighbor_k" type="number" value="30"></div>
 </div>
 <label><input type="checkbox" id="use_hyde"> HyDE 扩展</label>
 <label><input type="checkbox" id="use_multi_query"> Multi-Query 扩展</label>
 <label><input type="checkbox" id="llm_reranking"> LLM 重排序</label>
 <div class="row">
  <div><label>召回样本</label><input id="sample" type="number" value="30"></div>
  <div><label>top N</label><input id="top_n" type="number" value="10"></div>
 </div>
 <label><input type="checkbox" id="expand_upstream" onchange="tokenEstimate()"> 上游页面组扩充</label>
 <div class="row">
  <div><label>核心页面数</label><input id="expand_top_k" type="number" value="5" min="3" max="10" onchange="tokenEstimate()"></div>
  <div><label>上下扩充页数</label><input id="expand_ctx" type="number" value="1" min="1" max="3" onchange="tokenEstimate()"></div>
 </div>
 <div id="token_est" style="font-size:12px;margin:4px 0"></div>
 <label>数据年份 (逗号分隔, 空=全部)</label>
 <input id="years" type="text" placeholder="2023,2024">
 <label>多轮对话窗口</label>
 <input id="history_n" type="number" value="3">
 <h3>问题库</h3>
 <div id="bank"></div>
</div>
<div id="main">
 <h2>金盘科技年报问答 <small style="color:#888">PyTorch + CUDA</small></h2>
 <div class="modes">
  <button id="mode_qa" class="on" onclick="setMode('qa')">问答</button>
  <button id="mode_eval" onclick="setMode('eval')">评估结果分析</button>
 </div>
 <div id="view_qa">
  <div id="history"></div>
  <input id="q" placeholder="例如：2024年营业收入是多少？" />
  <button onclick="ask()">提问</button>
  <div id="answer"></div>
  <div class="tabs" id="tabs"></div>
  <div class="panel" id="panel"></div>
 </div>
 <div id="view_eval" style="display:none">
  <p style="font-size:13px;color:#555">每行一条：<code>问题 || 标准答案</code>。
  运行后逐题走完整检索-问答流程并用 LLM 评审打分（生成 1.0/0.3/0.0 与理由）。</p>
  <textarea id="eval_in">2024年营业收入是多少？ || 68.88亿元
2023年净利润是多少？ || 5.02亿元</textarea>
  <button onclick="runEval()">运行评估</button>
  <div id="eval_stats"></div>
  <div class="panel" id="eval_table" style="max-height:70vh"></div>
 </div>
</div>
<div class="pageview" id="pageview" onclick="this.style.display='none'"></div>
<script>
let HISTORY = [], LAST = null;
const TABS = [
 ["分析", r => esc(r.step_by_step_analysis || "")],
 ["推理摘要", r => esc(r.reasoning_summary || "")],
 ["引用页", r => refsTable(r.references || [])],
 ["召回chunks", r => chunksTable(r.all_retrieved_chunks || [])],
 ["初始召回", r => chunksTable(r.initial_retrieval_results || [])],
 ["算法贡献", r => contribView(r.algorithm_contribution)],
 ["遍历详情", r => esc(JSON.stringify(r.retrieval_details || null, null, 2))],
 ["查询扩展", r => esc(JSON.stringify(r.expansion_texts || {}, null, 2))],
 ["提示词", r => esc(JSON.stringify(r.prompt_info || {}, null, 2))],
 ["耗时", r => esc(JSON.stringify(r.timing || {}, null, 2))],
];
function esc(s){const d=document.createElement('div');d.textContent=s;
  return d.innerHTML.replace(/"/g,'&quot;').replace(/'/g,'&#39;');}
function pageLink(sha1, page) {
  // sha1 is a document FILENAME — it rides in a data attribute (esc is
  // quote-safe) instead of being spliced into inline JS, where a quote
  // in the name would break the handler or inject markup
  return `<a href="#" class="pg" data-sha1="${esc(String(sha1))}" data-page="${+page}">${esc(String(page))}</a>`;
}
document.addEventListener('click', e => {
  const a = e.target.closest('a.pg');
  if (a) { e.preventDefault(); showPage(a.dataset.sha1, +a.dataset.page); }
});
async function showPage(sha1, page) {
  const r = await fetch(`/api/page?doc=${encodeURIComponent(sha1)}&page=${page}`);
  const d = await r.json();
  const pv = document.getElementById('pageview');
  let body = '';
  if (d.image_png_base64) {
    body += `<img src="data:image/png;base64,${d.image_png_base64}" style="width:100%">`;
  } else if (d.pdf_url) {
    // browser-native PDF render of the SOURCE page (#page anchor) —
    // stopPropagation so interacting with the frame doesn't close the pane
    body += `<iframe src="${d.pdf_url}" style="width:100%;height:55vh;border:1px solid #ccc" onclick="event.stopPropagation()"></iframe>`;
  }
  body += `<div style="white-space:pre-wrap">${esc(d.text || d.error || '(无内容)')}</div>`;
  pv.innerHTML = `<h4>${esc(sha1)} · 第 ${page} 页 <small>(点击关闭)</small></h4>` + body;
  pv.style.display = 'block';
}
function refsTable(refs) {
  if (!refs.length) return "(空)";
  let h = "<table><tr><th>文档</th><th>页码</th></tr>";
  for (const r of refs) {
    const sha = r.pdf_sha1 || r.source_sha1 || "";
    h += `<tr><td>${esc(String(sha))}</td><td>${pageLink(sha, r.page_index ?? r.page)}</td></tr>`;
  }
  return h + "</table>";
}
function chunksTable(cs) {
  if (!cs.length) return "(空)";
  let h = "<table><tr><th>页</th><th>得分</th><th>命中</th><th>方法数</th><th>文本</th></tr>";
  for (const c of cs) {
    const score = (c.distance ?? c.vector_similarity ?? 0);
    const sha = c.source_sha1 || "";
    h += `<tr><td>${sha ? pageLink(sha, c.page) : esc(String(c.page))}</td><td>${score.toFixed ? score.toFixed(3) : esc(String(score))}</td><td>${c.hit_count ?? ""}</td><td>${c.method_count ?? ""}</td><td>${esc((c.text || "").slice(0, 160))}</td></tr>`;
  }
  return h + "</table>";
}
function contribView(ac) {
  if (!ac) return "(仅 hybrid_expansion 方法提供)";
  let h = `<b>Basic 召回:</b> ${ac.basic_retrieval_count} · ` +
          `<b>SSG 新发现:</b> ${ac.ssg_new_chunks_count} · ` +
          `<b>Triangulation 新发现:</b> ${ac.triangulation_new_chunks_count}<br>`;
  for (const m of ["ssg", "triangulation"]) {
    const st = ac[m + "_stats"] || {};
    h += `<br><b>${m}</b>: 扩展 ${st.total_expanded ?? 0}，新增 ${st.new_only ?? 0}，已在Top50 ${st.in_basic_top50 ?? 0}`;
  }
  const rows = [...(ac.ssg_new_chunks||[]).map(c=>["SSG",c]), ...(ac.triangulation_new_chunks||[]).map(c=>["Tri",c])];
  if (rows.length) {
    h += "<br><br><table><tr><th>方法</th><th>chunk</th><th>页</th><th>文档</th></tr>";
    for (const [m, c] of rows.slice(0, 50))
      h += `<tr><td>${m}</td><td>${c.chunk_id}</td><td>${pageLink(c.source_sha1, c.page)}</td><td>${esc(c.source_sha1)}</td></tr>`;
    h += "</table>";
  }
  return h;
}
function renderTabs() {
  const tabs = document.getElementById("tabs"); tabs.innerHTML = "";
  TABS.forEach(([name, fn], i) => {
    const b = document.createElement("button");
    b.textContent = name;
    b.onclick = () => { document.querySelectorAll('.tabs button').forEach(x => x.classList.remove('on'));
      b.classList.add('on');
      document.getElementById("panel").innerHTML = fn(LAST); };
    tabs.appendChild(b);
  });
}
function setMode(m) {
  document.getElementById('view_qa').style.display = m === 'qa' ? '' : 'none';
  document.getElementById('view_eval').style.display = m === 'eval' ? '' : 'none';
  document.getElementById('mode_qa').classList.toggle('on', m === 'qa');
  document.getElementById('mode_eval').classList.toggle('on', m === 'eval');
}
function tokenEstimate() {
  // Reference app_jinpan_qa.py:1801-1808: pages = K*(2*ctx+1), ~800
  // tokens/page, warn >15k, alarm >25k.
  const el = document.getElementById("token_est");
  if (!document.getElementById("expand_upstream").checked) { el.innerHTML = ""; return; }
  const k = +document.getElementById("expand_top_k").value || 5;
  const c = +document.getElementById("expand_ctx").value || 1;
  const pages = k * (2 * c + 1), tokens = pages * 800;
  const [icon, color] = tokens > 25000 ? ["🚨", "#c0262d"] :
                        tokens > 15000 ? ["⚠️", "#9a6b00"] : ["✅", "#0a7d32"];
  el.innerHTML = `<span style="color:${color}">${icon} 预计 ${pages} 页上下文 · Token 预估 ${tokens.toLocaleString()}</span>`;
}
function cfgFromSidebar(extra) {
  return Object.assign({
    method: document.getElementById("method").value,
    max_hops: +document.getElementById("max_hops").value,
    neighbor_k: +document.getElementById("neighbor_k").value,
    use_hyde: document.getElementById("use_hyde").checked,
    use_multi_query: document.getElementById("use_multi_query").checked,
    llm_reranking: document.getElementById("llm_reranking").checked,
    sample_size: +document.getElementById("sample").value,
    top_n: +document.getElementById("top_n").value,
    expand_upstream: document.getElementById("expand_upstream").checked,
    expand_top_k: +document.getElementById("expand_top_k").value,
    expand_context_size: +document.getElementById("expand_ctx").value,
    years: document.getElementById("years").value.split(",").map(s=>parseInt(s)).filter(x=>!isNaN(x)),
  }, extra || {});
}
async function ask() {
  const q = document.getElementById("q").value.trim();
  if (!q) return;
  document.getElementById("answer").innerHTML = "<div class='answer'>⏳ 检索与生成中…</div>";
  const cfg = cfgFromSidebar({
    question: q,
    history: (n => n > 0 ? HISTORY.slice(-n) : [])(+document.getElementById("history_n").value || 0),
  });
  const res = await fetch("/api/ask", {method:"POST", headers:{"Content-Type":"application/json"}, body: JSON.stringify(cfg)});
  const data = await res.json();
  if (data.error) { document.getElementById("answer").innerHTML = `<div class='answer'>❌ ${esc(data.error)}</div>`; return; }
  LAST = data;
  HISTORY.push({question: q, answer: String(data.final_answer)});
  document.getElementById("history").innerHTML = HISTORY.map(h=>`<div class='hist'>Q: ${esc(h.question)} → ${esc(h.answer)}</div>`).join("");
  document.getElementById("answer").innerHTML = `<div class='answer'>${esc(String(data.final_answer))}</div>`;
  renderTabs();
  document.querySelector('.tabs button')?.click();
}
async function runEval() {
  const lines = document.getElementById("eval_in").value.split("\\n").map(s=>s.trim()).filter(Boolean);
  const records = lines.map(l => { const [q, a] = l.split("||").map(s=>s.trim()); return {question:q, standard_answer:a||""}; });
  if (!records.length) return;
  document.getElementById("eval_stats").innerHTML = "⏳ 运行 " + records.length + " 题…";
  const res = await fetch("/api/eval_run", {method:"POST", headers:{"Content-Type":"application/json"},
    body: JSON.stringify(cfgFromSidebar({records}))});
  const data = await res.json();
  if (data.error) { document.getElementById("eval_stats").innerHTML = "❌ " + esc(data.error); return; }
  const st = data.statistics || {};
  document.getElementById("eval_stats").innerHTML =
    `<div class='answer'>平均得分 <b>${st.avg_score ?? "?"}</b> · 正确率 <b>${st.accuracy ?? "?"}</b> · 已评 ${st.total ?? data.records.length} 题</div>`;
  let h = "<table><tr><th>问题</th><th>标准答案</th><th>系统回答</th><th>得分</th><th>评审理由</th></tr>";
  for (const r of data.records) {
    const ev = r.evaluation || {};
    const cls = (ev.score ?? 0) >= 0.99 ? "score-ok" : ((ev.score ?? 0) > 0 ? "" : "score-bad");
    h += `<tr><td>${esc(r.question)}</td><td>${esc(String(r.standard_answer))}</td><td>${esc(String(r.rag_answer ?? ""))}</td><td class='${cls}'>${ev.score ?? "-"}</td><td>${esc(String(ev.reasoning ?? r.error ?? ""))}</td></tr>`;
  }
  document.getElementById("eval_table").innerHTML = h + "</table>";
}
document.getElementById("q").addEventListener("keydown", e => { if (e.key === "Enter") ask(); });
fetch("/api/bank").then(r=>r.json()).then(bank => {
  let h = "";
  for (const [cat, qs] of Object.entries(bank)) {
    h += `<div class='cat'>${esc(cat)}</div>`;
    h += qs.map(q=>`<div class='hist' style='cursor:pointer' onclick='document.getElementById("q").value=${JSON.stringify(q)}'>· ${esc(q)}</div>`).join("");
  }
  document.getElementById("bank").innerHTML = h;
});
</script>
</body>
</html>"""

# Categorized question bank (the reference ships a 127-question bank with
# categories, app_jinpan_qa.py; its CSVs are not reproduced — these are
# original questions over the same category taxonomy, at the same scale).
DEFAULT_QUESTION_BANK: Dict[str, List[str]] = {
    "财务数据": [
        "2024年营业收入是多少？",
        "2023年净利润是多少？",
        "2024年相比2023年营业收入增长了多少？",
        "经营活动现金流量净额是多少？",
        "资产负债率的变化趋势如何？",
        "2024年归母净利润是多少？",
        "2023年扣非净利润是多少？",
        "2024年毛利率是多少？",
        "近两年毛利率的变化情况如何？",
        "2024年基本每股收益是多少？",
        "2023年加权平均净资产收益率是多少？",
        "2024年末总资产是多少？",
        "2024年末归属于上市公司股东的净资产是多少？",
        "2024年销售费用是多少？",
        "2024年管理费用同比变化多少？",
        "2024年财务费用是多少？",
        "2023年投资活动现金流量净额是多少？",
        "2024年筹资活动现金流量净额是多少？",
        "2024年末货币资金余额是多少？",
        "2024年末存货余额是多少？",
        "2024年末应收账款余额是多少？",
        "应收账款占营业收入的比例是多少？",
        "2024年计提的资产减值损失是多少？",
        "2024年政府补助金额是多少？",
        "2023年所得税费用是多少？",
        "2024年末短期借款余额是多少？",
        "2024年末长期借款余额是多少？",
        "2024年末商誉余额是多少？",
        "2024年利息支出是多少？",
        "2024年汇兑损益对利润的影响是多少？",
    ],
    "业务构成": [
        "公司主要产品有哪些？",
        "干式变压器业务的收入占比是多少？",
        "储能业务的发展情况如何？",
        "2024年干式变压器的收入是多少？",
        "2024年储能产品的收入是多少？",
        "数字化工厂业务包括哪些内容？",
        "新能源业务板块的收入占比如何变化？",
        "2024年各产品线的毛利率分别是多少？",
        "海上风电相关产品的收入情况如何？",
        "充电桩业务的进展如何？",
        "2024年新签订单金额是多少？",
        "在手订单中海外订单的占比是多少？",
        "主营业务收入与其他业务收入的构成如何？",
        "2024年哪个业务板块增长最快？",
        "光伏配套产品的销售情况如何？",
    ],
    "研发与技术": [
        "研发费用占营业收入的比例是多少？",
        "公司有多少项专利？",
        "2024年研发投入总额是多少？",
        "研发人员数量及占比是多少？",
        "2024年新增授权专利多少项？",
        "公司的核心技术有哪些？",
        "研发投入资本化的比例是多少？",
        "2024年有哪些新产品完成研发？",
        "公司参与制定了哪些行业标准？",
        "固态变压器技术的研发进展如何？",
        "与高校或科研院所有哪些合作？",
        "研发费用近三年的变化趋势如何？",
    ],
    "市场与客户": [
        "海外市场收入占比如何？",
        "前五大客户的销售占比是多少？",
        "2024年境外收入是多少？",
        "北美市场的收入情况如何？",
        "欧洲市场的拓展进展如何？",
        "公司主要客户有哪些类型？",
        "对单一客户是否存在重大依赖？",
        "2024年出口业务的毛利率是多少？",
        "国内市场与国际市场的收入比例如何变化？",
        "数据中心客户贡献的收入情况如何？",
        "公司在东南亚市场有哪些布局？",
        "新开拓了哪些海外生产基地？",
    ],
    "公司治理": [
        "公司是否进行了现金分红？",
        "董事会有多少名独立董事？",
        "2024年度利润分配预案是什么？",
        "每10股派发现金红利多少元？",
        "2024年分红比例占净利润的百分比是多少？",
        "公司实际控制人是谁？",
        "前十大股东持股比例合计是多少？",
        "报告期内是否实施了股权激励计划？",
        "股权激励的考核目标是什么？",
        "监事会由多少人组成？",
        "报告期内召开了几次股东大会？",
        "高管薪酬总额是多少？",
        "是否存在控股股东股权质押情况？",
        "公司是否回购了股份？",
    ],
    "风险与合规": [
        "公司面临的主要经营风险有哪些？",
        "原材料价格波动对公司的影响如何？",
        "汇率波动风险如何应对？",
        "是否存在重大未决诉讼？",
        "报告期内是否受到监管处罚？",
        "海外贸易政策变化的风险如何？",
        "审计机构出具了什么类型的审计意见？",
        "关联交易的金额和定价原则是什么？",
        "对外担保的余额是多少？",
        "内部控制是否存在重大缺陷？",
    ],
    "产能与运营": [
        "公司有哪些生产基地？",
        "2024年产能利用率如何？",
        "在建工程的主要项目有哪些？",
        "募投项目的建设进度如何？",
        "2024年资本开支是多少？",
        "存货周转天数是多少？",
        "应收账款周转率如何变化？",
        "主要原材料的采购情况如何？",
        "前五大供应商的采购占比是多少？",
        "海外工厂的产能情况如何？",
    ],
    "人力资源": [
        "公司员工总数是多少？",
        "生产人员、技术人员的构成比例如何？",
        "员工薪酬总额是多少？",
        "核心技术人员是否发生变动？",
        "公司的人才引进政策有哪些？",
        "员工持股计划的情况如何？",
    ],
    "战略与展望": [
        "公司未来的发展战略是什么？",
        "2025年的经营计划有哪些？",
        "管理层如何展望行业前景？",
        "公司在双碳目标下有哪些机遇？",
        "国际化战略的推进计划是什么？",
        "是否有并购或对外投资计划？",
        "新能源行业竞争格局对公司的影响如何？",
        "公司如何应对行业价格竞争？",
    ],
    "多年对比": [
        "2020年到2024年营业收入的复合增长率是多少？",
        "近三年净利润分别是多少？",
        "近三年研发投入的变化趋势如何？",
        "2022年与2023年的毛利率对比如何？",
        "近五年资产负债率如何变化？",
        "近三年经营性现金流与净利润的比值如何？",
        "近三年海外收入占比的变化趋势是什么？",
        "2021年以来股利分配政策有何变化？",
        "近三年存货余额的变化情况如何？",
        "近三年员工人数如何变化？",
    ],
}


class QAWebApp:
    def __init__(
        self,
        processor: QuestionsProcessor,
        default_company: str = "金盘科技",
        question_bank: Optional[Dict[str, List[str]]] = None,
        pdf_dir=None,
    ):
        self.processor = processor
        self.default_company = default_company
        if isinstance(question_bank, list):  # back-compat: flat list
            question_bank = {"问题库": question_bank}
        self.question_bank = question_bank or DEFAULT_QUESTION_BANK
        # source PDFs for the image page viewer (reference renders cited
        # pages as images, app_jinpan_qa.py:307-352); None → text-only
        self.pdf_dir = pdf_dir
        # (sha1, page) → page text: the processor already builds exactly
        # this map; reuse it (one copy, one key normalization)
        self._page_text = {
            (sha1, int(page)): text
            for (sha1, page), text in processor._page_text.items()
        }

    def _page_image(self, sha1: str, pageno: int) -> Optional[str]:
        """Base64 PNG of the cited PDF page when PyMuPDF AND the source
        PDF are both present (reference app_jinpan_qa.py:307-352 —
        1-based page → 0-based fitz index); None → caller falls back to
        the indexed text."""
        if self.pdf_dir is None:
            return None
        try:
            import fitz  # PyMuPDF — optional, absent in this image
        except ImportError:
            return None
        from pathlib import Path

        pdf_path = Path(self.pdf_dir) / f"{sha1}.pdf"
        if not pdf_path.exists():
            return None
        try:
            import base64

            with fitz.open(str(pdf_path)) as doc:
                if not (1 <= pageno <= doc.page_count):
                    return None
                pix = doc[pageno - 1].get_pixmap(dpi=110)
                return base64.b64encode(pix.tobytes("png")).decode("ascii")
        except Exception:
            return None

    def _pdf_path(self, sha1: str):
        """Source PDF path for a sha1, or None — refuses names that could
        escape pdf_dir (sha1 comes from a URL query)."""
        if self.pdf_dir is None or not sha1 or "/" in sha1 or "\\" in sha1 \
                or ".." in sha1:
            return None
        from pathlib import Path

        p = Path(self.pdf_dir) / f"{sha1}.pdf"
        return p if p.exists() else None

    def pdf_bytes(self, query: Dict[str, List[str]]) -> Optional[bytes]:
        """Raw source-PDF bytes for ``/api/pdf?doc=sha1`` — the browser's
        native viewer renders it, and the client opens it with a
        ``#page=N`` anchor, giving true cited-PAGE viewing (reference
        app_jinpan_qa.py:307-352) with no rasterizer dependency."""
        p = self._pdf_path((query.get("doc") or [""])[0])
        return p.read_bytes() if p is not None else None

    def page(self, query: Dict[str, List[str]]) -> Dict:
        """Cited-page viewer (reference app_jinpan_qa.py:307-352): a PDF
        page image when PyMuPDF + the source PDF are available, plus a
        ``pdf_url`` (#page anchor into /api/pdf) whenever the source PDF
        exists, the indexed page text always — same navigation contract
        (1-based page numbers)."""
        sha1 = (query.get("doc") or [""])[0]
        try:
            pageno = int((query.get("page") or ["0"])[0])
        except ValueError:
            return {"error": "page must be an integer"}
        text = self._page_text.get((sha1, pageno))
        if text is None:
            return {"error": f"no indexed page {pageno} in {sha1}"}
        out = {"doc": sha1, "page": pageno, "text": text}
        if self._pdf_path(sha1) is not None:
            from urllib.parse import quote

            out["pdf_url"] = f"/api/pdf?doc={quote(sha1)}#page={pageno}"
        img = self._page_image(sha1, pageno)
        if img is not None:
            out["image_png_base64"] = img
        return out

    def evaluate(self, payload: Dict) -> Dict:
        """LLM-judge pre-answered records: POST {records: [{question,
        standard_answer, rag_answer}]} → judged + stats."""
        records = payload.get("records", [])
        if not isinstance(records, list) or not records:
            return {"error": "records must be a non-empty list"}
        harness = JudgeHarness(self.processor.llm)
        return harness.judge_all(records)

    def eval_run(self, payload: Dict) -> Dict:
        """The full evaluation-analysis flow (reference app_jinpan_qa.py
        :2846+): answer each question through the pipeline with the current
        sidebar config, then LLM-judge against the standard answer."""
        records = payload.get("records", [])
        if not isinstance(records, list) or not records:
            return {"error": "records must be a non-empty list"}

        def answer_one(rec: Dict) -> Dict:
            q = str(rec.get("question", "")).strip()
            out = dict(rec)
            if not q:
                out["rag_answer"] = ""
                out["error"] = "empty question"
                return out
            try:
                ans = self.ask({**payload, "question": q, "history": None})
                out["rag_answer"] = str(ans.get("final_answer", ans.get("error", "")))
                out["references"] = ans.get("references", [])
            except Exception as e:  # one bad question must not discard
                out["rag_answer"] = ""  # the rest of the batch's work
                out["error"] = f"{type(e).__name__}: {e}"
            return out

        # answer concurrently, parallel_requests wide — a 127-question run
        # through a real LLM would crawl sequentially (the reference
        # batches QA the same way, src/questions_processing.py:1120-1130);
        # `ask` already isolates per-request config/reranker state
        try:  # a malformed optional knob must not discard the batch
            workers = max(1, int(payload.get("parallel_requests") or 0))
        except (TypeError, ValueError):
            workers = 0
        workers = workers or max(1, self.processor.config.parallel_requests)
        if workers == 1 or len(records) == 1:
            answered = [answer_one(r) for r in records]
        else:
            from concurrent.futures import ThreadPoolExecutor

            with ThreadPoolExecutor(max_workers=workers) as pool:
                answered = list(pool.map(answer_one, records))
        harness = JudgeHarness(self.processor.llm)
        return harness.judge_all(answered)

    def ask(self, payload: Dict) -> Dict:
        question = payload.get("question", "").strip()
        if not question:
            return {"error": "empty question"}
        companies = self.processor._extract_companies(question)
        q = question if companies else f"{self.default_company}{question}"
        company = companies[0] if companies else self.default_company

        cfg = self.processor.config
        new_cfg = dataclasses.replace(
            cfg,
            retrieval_method=payload.get("method", cfg.retrieval_method),
            max_hops=int(payload.get("max_hops", cfg.max_hops)),
            neighbor_k=int(payload.get("neighbor_k", cfg.neighbor_k)),
            use_hyde=bool(payload.get("use_hyde", cfg.use_hyde)),
            use_multi_query=bool(payload.get("use_multi_query", cfg.use_multi_query)),
            llm_reranking=bool(payload.get("llm_reranking", cfg.llm_reranking))
            and self.processor.reranker is not None,
            llm_reranking_sample_size=int(payload.get("sample_size", cfg.llm_reranking_sample_size)),
            top_n_retrieval=int(payload.get("top_n", cfg.top_n_retrieval)),
            expand_upstream=bool(payload.get("expand_upstream", cfg.expand_upstream)),
            expand_top_k=int(payload.get("expand_top_k", cfg.expand_top_k)),
            expand_context_size=int(
                payload.get("expand_context_size", cfg.expand_context_size)
            ),
        )
        years = payload.get("years") or None
        history = payload.get("history") or None
        # per-request shallow copy: concurrent sessions never observe each
        # other's config (the engine/index are shared and read-only; the
        # engine's route cache and the kernel build take locks, and the
        # GIL serialises the launches) — the
        # reference likewise serves concurrent Streamlit sessions.
        # The reranker keeps per-run mutable stats (reset_stats at the top
        # of rerank_documents), so each request gets its OWN reranker copy
        # with a private stats lock — sharing it lets session B's reset
        # wipe session A's in-flight counters.  Provider and rate limiter
        # stay shared (the QPS budget is global by design).
        import copy
        from threading import Lock

        proc = copy.copy(self.processor)
        proc.config = new_cfg
        if proc.reranker is not None:
            rr = copy.copy(proc.reranker)
            rr._stats_lock = Lock()
            rr.reset_stats()
            proc.reranker = rr
        return proc.get_answer_for_company(
            company, q, new_cfg.schema,
            conversation_history=history, selected_years=years,
        )

    # -------------------------------------------------------------- server
    def make_server(self, host: str = "127.0.0.1", port: int = 8899) -> ThreadingHTTPServer:
        app = self

        class Handler(BaseHTTPRequestHandler):
            def _send(self, code: int, body: bytes, ctype: str):
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                parsed = urlparse(self.path)
                if parsed.path in ("/", "/index.html"):
                    self._send(200, _PAGE.encode(), "text/html; charset=utf-8")
                elif parsed.path == "/api/bank":
                    self._send(200, json.dumps(app.question_bank, ensure_ascii=False).encode(),
                               "application/json")
                elif parsed.path == "/api/page":
                    body = json.dumps(app.page(parse_qs(parsed.query)), ensure_ascii=False)
                    self._send(200, body.encode(), "application/json")
                elif parsed.path == "/api/pdf":
                    blob = app.pdf_bytes(parse_qs(parsed.query))
                    if blob is None:
                        self._send(404, b"no such pdf", "text/plain")
                    else:
                        self._send(200, blob, "application/pdf")
                else:
                    self._send(404, b"not found", "text/plain")

            def do_POST(self):
                routes = {
                    "/api/ask": app.ask,
                    "/api/eval": app.evaluate,
                    "/api/eval_run": app.eval_run,
                }
                handler = routes.get(self.path)
                if handler is None:
                    self._send(404, b"{}", "application/json")
                    return
                try:
                    n = int(self.headers.get("Content-Length", 0))
                    payload = json.loads(self.rfile.read(n) or b"{}")
                    result = handler(payload)
                except Exception as e:
                    result = {"error": f"{type(e).__name__}: {e}"}
                self._send(200, json.dumps(result, ensure_ascii=False, default=str).encode(),
                           "application/json")

            def log_message(self, *a):
                pass

        return ThreadingHTTPServer((host, port), Handler)


def serve(processor: QuestionsProcessor, host: str = "127.0.0.1", port: int = 8899,
          **kwargs) -> None:  # pragma: no cover - blocking entry point
    server = QAWebApp(processor, **kwargs).make_server(host, port)
    print(f"QA web app listening on http://{host}:{port}")
    server.serve_forever()
