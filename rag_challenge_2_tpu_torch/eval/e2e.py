"""End-to-end quality harness over a REAL-prose PDF fixture corpus.

The reference validates its full pipeline against a 127-question benchmark
with standard answers judged by an LLM (reference
金盘benchmark测试-新的表格.csv + src/api_requests.py:697-750).  That bench
cannot ship here (live APIs, proprietary PDFs), and the repo's other
quality numbers (eval/encoder_quality.py) run on template-generated
chunks that never touch the ingestion layers.  This module closes the
gap with a self-contained end-to-end run:

  annual-report-style PDFs (written from scratch below, digital-text with
  CID fonts + ToUnicode CMaps) → parse (ingestion/minipdf) → merge →
  chunk → encode → index (dense + BM25 CSR) → year-routed hybrid query →
  two-stage answering (page selection + schema-typed answer) → score
  against golden answers with the competition comparator
  (eval/scorer.compare — reference rank.py:78-127).

The LLM seat is taken by :class:`ExtractiveStubProvider` — a
deterministic rule-based answerer that reads ONLY the context the
pipeline assembled for it.  That makes the metric an honest measure of
what the framework owns (parsing fidelity, chunk/index quality,
retrieval, routing, context assembly): if the right page never reaches
the answer stage, extraction fails and the scorer records it.  It is NOT
a measure of LLM answering quality — the reference rents that too.

The fixture corpus is original fiction: three invented companies, two
fiscal years each, with varied section prose (no shared templates with
eval/encoder_quality.py and no text from the reference).

Port of ``rag_challenge_2_tpu/eval/e2e.py``: the PDF writer, the fixture,
the golden questions and the answerer are host code, copied; ``run_e2e``
drives the port's ``Pipeline`` and encoder on ``device`` (the card unless
the caller names another).  Pretraining (``pretrain_steps > 0``) is not
ported yet and raises.
"""

from __future__ import annotations

import json
import os
import re
import zlib
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple, Union

from ..device import DeviceLike, resolve_device
from ..llm.providers import StubProvider

# --------------------------------------------------------------- PDF writer


def _cmap_stream(cid_of: Dict[str, int]) -> bytes:
    """ToUnicode CMap mapping our CIDs to UTF-16BE code points
    (bfchar blocks of ≤100 entries, per the CMap spec)."""
    entries = [
        (cid, ch) for ch, cid in sorted(cid_of.items(), key=lambda kv: kv[1])
    ]
    blocks = []
    for i in range(0, len(entries), 100):
        chunk = entries[i : i + 100]
        lines = [b"%d beginbfchar" % len(chunk)]
        for cid, ch in chunk:
            u16 = ch.encode("utf-16-be").hex().upper()
            lines.append(b"<%04X> <%s>" % (cid, u16.encode()))
        lines.append(b"endbfchar")
        blocks.append(b"\n".join(lines))
    return b"begincmap\n" + b"\n".join(blocks) + b"\nendcmap"


def write_pdf(pages: Sequence[Union[str, Dict]]) -> bytes:
    """Assemble a digital-text PDF (one Type0 font, 2-byte CIDs, Flate
    streams) whose pages extract back to ``pages`` via
    :func:`ingestion.minipdf.extract_pdf_pages` — the file format every
    digitally-produced Chinese annual report ships.

    A page may be a plain string or ``{"text": str, "table": [[cell]]}``
    — table cells are positioned with per-cell ``Tm`` at column origins
    (the way office print pipelines emit tables), which is exactly the
    geometry :func:`ingestion.minipdf._detect_tables` recovers a grid
    from."""
    def _text_of(p):
        return p["text"] if isinstance(p, dict) else p

    def _cells_of(p):
        return [c for row in p.get("table", []) for c in row] \
            if isinstance(p, dict) else []

    chars = sorted({
        c for p in pages
        for s in ([_text_of(p)] + _cells_of(p))
        for c in s.replace("\n", "")
    })
    cid_of = {c: i + 1 for i, c in enumerate(chars)}
    if len(cid_of) > 0xFFFE:
        raise ValueError("fixture exceeds the 2-byte CID space")

    def _hex(s: str) -> bytes:
        return "".join(f"{cid_of[c]:04X}" for c in s).encode()

    def content(page: Union[str, Dict]) -> bytes:
        ops = [b"BT /F1 10 Tf 14 TL 56 780 Td"]
        for li, line in enumerate(_text_of(page).split("\n")):
            if li > 0:
                ops.append(b"T*")
            ops.append(b"<%s> Tj" % _hex(line))
        ops.append(b"ET")
        if isinstance(page, dict):
            for r, row in enumerate(page.get("table", [])):
                for c, cell in enumerate(row):
                    if not cell:
                        continue
                    ops.append(
                        b"BT /F1 10 Tf 1 0 0 1 %d %d Tm <%s> Tj ET"
                        % (56 + 150 * c, 500 - 16 * r, _hex(cell))
                    )
        return zlib.compress(b" ".join(ops))

    cmap = _cmap_stream(cid_of)
    n_pages = len(pages)
    # object layout: 1 catalog, 2 pages, 3 font, 4 ToUnicode,
    # then per page i: 5+2i page obj, 6+2i content stream
    kids = b" ".join(b"%d 0 R" % (5 + 2 * i) for i in range(n_pages))
    objs: Dict[int, bytes] = {
        1: b"<< /Type /Catalog /Pages 2 0 R >>",
        2: b"<< /Type /Pages /Kids [%s] /Count %d >>" % (kids, n_pages),
        3: (b"<< /Type /Font /Subtype /Type0 /BaseFont /FixtureGB "
            b"/Encoding /Identity-H /ToUnicode 4 0 R >>"),
        4: b"<< /Length %d >>\nstream\n%s\nendstream" % (len(cmap), cmap),
    }
    for i, page in enumerate(pages):
        c = content(page)
        objs[5 + 2 * i] = (
            b"<< /Type /Page /Parent 2 0 R /MediaBox [0 0 595 842] "
            b"/Contents %d 0 R /Resources << /Font << /F1 3 0 R >> >> >>"
            % (6 + 2 * i)
        )
        objs[6 + 2 * i] = (
            b"<< /Length %d /Filter /FlateDecode >>\nstream\n%s\nendstream"
            % (len(c), c)
        )
    out = [b"%PDF-1.5"]
    offsets = {}
    pos = len(out[0]) + 1
    for n in sorted(objs):
        blob = b"%d 0 obj\n%s\nendobj\n" % (n, objs[n])
        offsets[n] = pos
        out.append(blob)
        pos += len(blob)
    # a real xref table so standards-compliant readers accept the file
    # (minipdf scavenges objects and ignores it)
    xref_pos = pos
    xref = [b"xref", b"0 %d" % (max(objs) + 1),
            b"0000000000 65535 f "]
    for n in range(1, max(objs) + 1):
        xref.append(b"%010d 00000 n " % offsets.get(n, 0))
    out.append(b"\n".join(xref) + b"\n")
    out.append(
        b"trailer << /Size %d /Root 1 0 R >>\nstartxref\n%d\n%%%%EOF\n"
        % (max(objs) + 1, xref_pos)
    )
    return b"\n".join(out[:1]) + b"\n" + b"".join(out[1:])


# ---------------------------------------------------------- fixture corpus
#
# Three invented companies; every number is fiction.  Prose is written in
# annual-report register with per-company variation in section structure
# and sentence shape — deliberately NOT the template generator of
# eval/encoder_quality.py.

_F = {
    # (company, year): revenue 亿元, net profit 亿元, gross margin %,
    #                  R&D 亿元, dividend (per-10-share yuan or None),
    #                  overseas %, products
    ("华岳电气", 2023): (128.64, 9.87, 21.36, 6.42, 3.2, 18.7,
                        ["干式变压器", "箱式变电站", "数字化监控系统"]),
    ("华岳电气", 2024): (151.02, 12.45, 22.81, 7.98, 4.1, 24.3,
                        ["干式变压器", "箱式变电站", "数字化监控系统"]),
    ("沧海储能", 2023): (86.30, 4.52, 17.90, 5.11, None, 9.6,
                        ["液冷储能电柜", "电池管理系统", "调频辅助服务平台"]),
    ("沧海储能", 2024): (117.80, 7.03, 19.40, 6.75, 1.5, 15.2,
                        ["液冷储能电柜", "电池管理系统", "调频辅助服务平台"]),
    ("启明数控", 2023): (42.19, 3.66, 31.75, 4.05, 2.0, 11.4,
                        ["五轴联动加工中心", "高精度伺服系统", "工业软件套件"]),
    ("启明数控", 2024): (48.77, 4.21, 30.90, 4.83, None, 13.8,
                        ["五轴联动加工中心", "高精度伺服系统", "工业软件套件"]),
}

_INTRO = {
    "华岳电气": ("华岳电气股份有限公司成立于一九九八年，总部位于西安，"
               "深耕输配电设备三十余年，产品销往四十多个国家和地区。"),
    "沧海储能": ("沧海储能科技股份有限公司是一家专注于电化学储能系统集成"
               "的高新技术企业，总部位于宁波，于二〇二〇年在科创板上市。"),
    "启明数控": ("启明数控装备股份有限公司主营高端数控机床及核心功能部件，"
               "总部位于沈阳，客户覆盖航空航天、汽车模具与通用机械行业。"),
}


def _doc_pages(company: str, year: int) -> List[str]:
    """Six pages of varied annual-report prose for one (company, year)."""
    rev, profit, margin, rd, div, overseas, products = _F[(company, year)]
    prev = _F.get((company, year - 1))
    prods = "、".join(products)

    p1 = (
        f"{company}\n{year}年年度报告\n\n第一节 公司简介\n"
        f"{_INTRO[company]}\n"
        f"公司主要产品包括{prods}等，"
        f"形成了覆盖研发、制造、服务的完整业务体系。\n"
        f"本报告所载财务数据按照中国企业会计准则编制，"
        f"除特别注明外，金额单位为人民币。"
    )
    if prev is not None:
        growth = (rev / prev[0] - 1) * 100
        rev_line = (
            f"报告期（{year}年度）内公司实现营业收入{rev}亿元，"
            f"较上年的{prev[0]}亿元增长{growth:.1f}%，创历史新高。"
        )
    else:
        rev_line = f"报告期（{year}年度）内公司实现营业收入{rev}亿元。"
    p2 = (
        f"第二节 经营情况讨论与分析\n"
        f"{rev_line}\n"
        f"实现归母净利润{profit}亿元，盈利质量持续改善。\n"
        f"{year}年公司综合毛利率为{margin}%，"
        f"主要受产品结构优化及原材料价格回落影响。\n"
        f"分区域看，海外收入占比为{overseas}%，"
        f"国际化战略稳步推进。"
    )
    p3 = (
        f"第三节 主营业务构成\n"
        f"公司收入主要来自{products[0]}与{products[1]}两大板块，"
        f"其中{products[0]}板块收入占比过半。\n"
        f"{products[2]}业务处于快速放量阶段，"
        f"报告期内新签订单同比显著增加。\n"
        f"公司坚持直销与经销并举的渠道策略，前五大客户收入占比保持稳定，"
        f"不存在对单一客户的重大依赖。"
    )
    p4 = (
        f"第四节 研发投入情况\n"
        f"公司{year}年度研发费用为{rd}亿元，占营业收入的比例为"
        f"{rd / rev * 100:.2f}%。\n"
        f"报告期内新增授权发明专利若干项，"
        f"多项在研项目进入样机验证阶段。\n"
        f"公司持续引进高层次研发人才，研发人员数量与薪酬总额均有增长。"
    )
    if div is not None:
        div_text = (
            f"经董事会审议通过，公司{year}年度利润分配预案为：\n"
            f"以实施权益分派股权登记日登记的总股本为基数，"
            f"向全体股东每10股派发现金红利{div}元（含税），"
            f"不送红股，不以公积金转增股本。"
        )
    else:
        div_text = (
            f"综合考虑公司所处发展阶段与资金需求，董事会决定"
            f"{year}年度不进行现金分红，不送红股，"
            f"不以公积金转增股本，留存资金将用于产能建设与研发投入。"
        )
    p5 = f"第五节 利润分配方案\n{div_text}"
    p6 = (
        f"第六节 财务报表摘要\n"
        f"资产负债表与利润表主要项目如下：\n"
        f"营业收入 {rev}亿元\n"
        f"归母净利润 {profit}亿元\n"
        f"研发费用 {rd}亿元\n"
        f"经审计的财务报表全文及附注详见公司指定信息披露媒体。"
    )
    # p7: a POSITIONED table (write_pdf renders cells with per-cell Tm)
    # whose figures appear nowhere in the prose — answering the 总资产 /
    # 资产负债率 questions requires the builtin parser's grid detector +
    # the table→markdown merge path (reference: TableFormer structure,
    # src/pdf_parsing.py:134-162 + tables md, :549-651)
    ta, ta_prev = _table_metrics(rev)
    ratio = round(38.0 + (rev * 7.0) % 15.0, 1)
    p7 = {
        "text": (
            "第七节 主要会计数据\n"
            "公司近两年主要资产负债数据如下表所示，"
            "表中金额均按期末数列示。"
        ),
        "table": [
            ["项目", f"{year}年末", f"{year - 1}年末"],
            ["总资产", f"{ta}亿元", f"{ta_prev}亿元"],
            ["资产负债率", f"{ratio}%", f"{round(ratio + 1.8, 1)}%"],
        ],
    }
    return [p1, p2, p3, p4, p5, p6, p7]


def _table_metrics(rev: float) -> Tuple[float, float]:
    """Deterministic fiction: period-end total assets from revenue."""
    ta = round(rev * 2.2 + 7.0, 2)
    return ta, round(ta * 0.88, 2)


def fixture_docs() -> List[Dict]:
    """The corpus: one dict per document (sha1, company, year, pages)."""
    tag = {"华岳电气": "huayue", "沧海储能": "canghai", "启明数控": "qiming"}
    return [
        {
            "sha1": f"J{year}_{tag[company]}",
            "company": company,
            "year": year,
            "pages": _doc_pages(company, year),
        }
        for (company, year) in sorted(_F, key=lambda cy: (cy[0], cy[1]))
    ]


# golden QA over the fixture (gold_page is 1-based)
GOLDEN_QA: List[Dict] = [
    {"question": "华岳电气2024年营业收入是多少亿元？", "schema": "number",
     "value": 151.02, "company": "华岳电气", "gold_page": 2},
    {"question": "华岳电气2023年研发费用是多少亿元？", "schema": "number",
     "value": 6.42, "company": "华岳电气", "gold_page": 4},
    {"question": "华岳电气2024年是否进行现金分红？", "schema": "boolean",
     "value": True, "company": "华岳电气", "gold_page": 5},
    {"question": "华岳电气的主要产品有哪些？", "schema": "names",
     "value": ["干式变压器", "箱式变电站", "数字化监控系统"],
     "company": "华岳电气", "gold_page": 1},
    {"question": "华岳电气2023年综合毛利率是多少？", "schema": "number",
     "value": 21.36, "company": "华岳电气", "gold_page": 2},
    {"question": "华岳电气2023年归母净利润是多少亿元？", "schema": "number",
     "value": 9.87, "company": "华岳电气", "gold_page": 2},
    {"question": "沧海储能2023年归母净利润是多少亿元？", "schema": "number",
     "value": 4.52, "company": "沧海储能", "gold_page": 2},
    {"question": "沧海储能2023年是否进行现金分红？", "schema": "boolean",
     "value": False, "company": "沧海储能", "gold_page": 5},
    {"question": "沧海储能2024年综合毛利率是多少？", "schema": "number",
     "value": 19.4, "company": "沧海储能", "gold_page": 2},
    {"question": "沧海储能2024年海外收入占比是多少？", "schema": "number",
     "value": 15.2, "company": "沧海储能", "gold_page": 2},
    {"question": "启明数控2023年营业收入是多少亿元？", "schema": "number",
     "value": 42.19, "company": "启明数控", "gold_page": 2},
    {"question": "启明数控2024年研发费用是多少亿元？", "schema": "number",
     "value": 4.83, "company": "启明数控", "gold_page": 4},
    {"question": "启明数控2024年是否进行现金分红？", "schema": "boolean",
     "value": False, "company": "启明数控", "gold_page": 5},
    {"question": "启明数控的主要产品有哪些？", "schema": "names",
     "value": ["五轴联动加工中心", "高精度伺服系统", "工业软件套件"],
     "company": "启明数控", "gold_page": 1},
    # table-only metrics (p7 grid — exercises minipdf table detection +
    # the markdown splice; the values appear in no prose block)
    {"question": "华岳电气2024年末总资产是多少亿元？", "schema": "number",
     "value": _table_metrics(151.02)[0], "company": "华岳电气",
     "gold_page": 7},
    # current-period only: a "2023年末" ask would also match the 2024
    # report's comparison column under the ±1-year route — a genuine
    # ambiguity the extractive stub cannot arbitrate
    {"question": "沧海储能2024年末总资产是多少亿元？", "schema": "number",
     "value": _table_metrics(117.80)[0], "company": "沧海储能",
     "gold_page": 7},
    {"question": "启明数控2024年资产负债率是多少？", "schema": "number",
     "value": round(38.0 + (48.77 * 7.0) % 15.0, 1), "company": "启明数控",
     "gold_page": 7},
]


def build_fixture(root: Path) -> None:
    """Write the PDF corpus + subset.csv + questions.json under ``root``
    (the reference data-set layout, reference src/pipeline.py:19-43)."""
    root = Path(root)
    pdf_dir = root / "pdf_reports"
    pdf_dir.mkdir(parents=True, exist_ok=True)
    rows = ["sha1,company_name,year"]
    for doc in fixture_docs():
        (pdf_dir / f"{doc['sha1']}.pdf").write_bytes(write_pdf(doc["pages"]))
        rows.append(f"{doc['sha1']},{doc['company']},{doc['year']}")
    (root / "subset.csv").write_text("\n".join(rows) + "\n", encoding="utf-8")
    questions = [
        {"question": g["question"], "schema": g["schema"]} for g in GOLDEN_QA
    ]
    (root / "questions.json").write_text(
        json.dumps(questions, ensure_ascii=False, indent=1), encoding="utf-8"
    )


# ------------------------------------------------- deterministic answerer

_METRICS = ["资产负债率", "总资产", "归母净利润", "综合毛利率", "毛利率",
            "营业收入", "研发费用", "海外收入占比", "净利润"]
_NUM_RE = r"([0-9]+(?:\.[0-9]+)?)"
_CTX_BLOCK_RE = re.compile(
    r'Text retrieved from page (\d+): \s*\n"""\n(.*?)\n"""', re.S
)


class ExtractiveStubProvider(StubProvider):
    """Deterministic rule-based stand-in for the answering LLM.

    Answers ONLY from the prompt content the pipeline assembled — page
    selection picks context blocks lexically matching the question, the
    answer stage regex-extracts the asked metric from the selected
    blocks.  No fixture knowledge is baked in: if retrieval misses the
    gold page, the extraction returns N/A and the scorer counts a miss.
    """

    def _complete(self, model, system_content, human_content, temperature, **kw):
        self.calls.append({"model": model, "system": system_content,
                           "user": human_content, "temperature": temperature})
        if "候选页面" in human_content:                    # stage 1
            return json.dumps(self._select_pages(human_content),
                              ensure_ascii=False)
        if '"""' in human_content:                         # stage 2
            return json.dumps(self._answer(system_content, human_content),
                              ensure_ascii=False)
        return "<SKIP>"

    # -- stage 1: page selection ------------------------------------------
    @staticmethod
    def _question_of(human: str) -> str:
        m = re.search(r"问题[:：]\s*(.+)", human)
        return m.group(1).strip().strip('"') if m else human[:60]

    @staticmethod
    def _blocks(human: str) -> List[Tuple[int, str]]:
        return [(int(p), t) for p, t in _CTX_BLOCK_RE.findall(human)]

    def _select_pages(self, human: str) -> Dict:
        q = self._question_of(human)
        metric = next((m for m in _METRICS if m in q), None)
        dividend = "分红" in q or "派发" in q
        names = "产品" in q
        ym = re.search(r"(20\d{2})年", q)
        year = ym.group(1) if ym else None
        scored = []
        for page, text in self._blocks(human):
            s = 0
            if metric and metric in text:
                s += 4
            if dividend and ("分红" in text or "派发" in text):
                s += 4
            if names and "产品" in text:
                s += 4
            # the asked fiscal year named in the block text disambiguates
            # same-metric blocks of the other routed years (the route is
            # the reference's ±1 window — routing.extract_years)
            if year and f"{year}年" in text:
                s += 2
            # bigram overlap as the generic signal
            bigrams = {q[i : i + 2] for i in range(len(q) - 1)}
            s += sum(1 for b in bigrams if b in text) / max(len(bigrams), 1)
            scored.append((s, page))
        scored.sort(key=lambda sp: (-sp[0], sp[1]))
        pages = []
        for s, p in scored:
            if s >= 4 and p not in pages:
                pages.append(p)
        if not pages:
            pages = [p for _, p in scored[:3]]
        return {"selected_pages": pages[:5],
                "reasoning": "lexical match on the asked metric"}

    # -- stage 2: schema-typed answer --------------------------------------
    def _answer(self, system: str, human: str) -> Dict:
        q = self._question_of(human)
        blocks = self._blocks(human)
        base = {"step_by_step_analysis": "extractive rule over the provided context",
                "reasoning_summary": "extractive", "relevant_pages": []}

        # prompt-class markers (llm/prompts.py AnswerWithRAGContext*Prompt)
        if "判断题" in system or ("是否" in q and "多少" not in q):
            ym = re.search(r"(20\d{2})年", q)
            year = ym.group(1) if ym else None
            passes = (
                [[(p, t) for p, t in blocks if f"{year}年" in t], blocks]
                if year else [blocks]
            )
            for blks in passes:
                for page, text in blks:
                    if "不进行现金分红" in text or "不派发现金红利" in text:
                        return {**base, "final_answer": False,
                                "relevant_pages": [page]}
                    if "派发现金红利" in text:
                        return {**base, "final_answer": True,
                                "relevant_pages": [page]}
            return {**base, "final_answer": False}

        if "名称列表" in system or ("产品" in q and ("哪些" in q or "列举" in q)):
            for page, text in blocks:
                # the item list ends at the first clause boundary (，/；/。)
                # — trailing boilerplate ("形成了…体系") is not a product
                mm = re.search(
                    r"(?:主要|主营)产品(?:包括|涵盖|有)([^。\n，；]+)", text
                )
                if mm:
                    items = re.split(r"[、,及和]", mm.group(1))
                    items = [i.strip("等 ") for i in items if i.strip("等 ")]
                    if items:
                        return {**base, "final_answer": items,
                                "relevant_pages": [page]}
            return {**base, "final_answer": "N/A"}

        metric = next((mt for mt in _METRICS if mt in q), None)
        if metric:
            # '比' excluded from the gap: "占营业收入的比例为9.60%" is the
            # ratio OF the metric, not the metric (measured false hit)
            pat = re.compile(
                re.escape(metric) + r"[^0-9。\n比]{0,14}?" + _NUM_RE
                + r"\s*(?:亿元|%|％)"
            )
            ym = re.search(r"(20\d{2})年", q)
            year = ym.group(1) if ym else None
            # pass 1: blocks naming the asked fiscal year (the route keeps
            # the reference's ±1-year window, so same-metric blocks from
            # adjacent years are legitimately in context); pass 2: any
            passes = (
                [[(p, t) for p, t in blocks if f"{year}年" in t], blocks]
                if year else [blocks]
            )
            for blks in passes:
                for page, text in blks:
                    mm = pat.search(text)
                    if mm:
                        return {**base, "final_answer": float(mm.group(1)),
                                "relevant_pages": [page]}
        return {**base, "final_answer": "N/A"}


# ----------------------------------------------------------------- runner


def run_e2e(
    root: Path,
    embedder=None,
    pretrain_steps: int = 0,
    use_bm25: bool = True,
    parallel_requests: int = 1,
    device: DeviceLike = None,
) -> Dict:
    """Drive the FULL pipeline over the fixture and score the answers.

    ``embedder`` defaults to a random-init encoder (seed 0, ``max_len``
    128) on ``device`` — BM25 rides along (``use_bm25``), matching the
    shipped hybrid preset.  ``pretrain_steps > 0`` raises: the port cannot
    pretrain the encoder yet.

    Returns ``{"value_accuracy", "page_hit", "n", "per_question"}`` where
    value_accuracy uses the competition comparator (1%-relative tolerance
    for numbers — eval/scorer.compare) and page_hit checks the golden
    page appears in the answer's validated references.
    """
    from ..pipeline.run import Pipeline, RunConfig, no_pretraining
    from .scorer import compare

    if pretrain_steps > 0:
        no_pretraining(f"pretrain_steps = {pretrain_steps}")
    device = resolve_device(device)
    root = Path(root)
    build_fixture(root)
    provider = ExtractiveStubProvider()
    rc = RunConfig(
        use_bm25_db=use_bm25,
        api_provider="stub",
        answering_model="stub",
        parallel_requests=parallel_requests,
        submission_file=False,
    )

    embedder_fn = embedder
    if embedder_fn is None:
        import torch

        from ..models.encoder import EmbeddingModel, EncoderConfig

        model = EmbeddingModel(EncoderConfig(max_len=128), device=device,
                               generator=torch.Generator().manual_seed(0))
        embedder_fn = model.embed

    pipe = Pipeline(root, rc, embedder=embedder_fn, provider=provider,
                    device=device)
    pipe.parse_pdf_reports(parser="builtin")
    pipe.merge_reports()
    pipe.chunk_reports()
    auto = os.environ.get("RAGTPU_AUTO_PRETRAIN")
    os.environ["RAGTPU_AUTO_PRETRAIN"] = "0"   # embedder passed explicitly
    try:
        pipe.create_vector_dbs()
    finally:
        if auto is None:
            os.environ.pop("RAGTPU_AUTO_PRETRAIN", None)
        else:
            os.environ["RAGTPU_AUTO_PRETRAIN"] = auto

    processor = pipe.build_processor()
    per_q = []
    hits, page_hits = 0.0, 0
    for g in GOLDEN_QA:
        ans = processor.process_question(g["question"], g["schema"])
        got = ans.get("final_answer")
        gold = g["value"]
        # scorer gold format (eval/scorer.compare): numbers/bools as str(),
        # names as a comma-joined list
        if isinstance(gold, list):
            gold_str = ",".join(gold)
        else:
            gold_str = str(gold)
        score = compare(g["schema"], gold_str, got)
        hits += score
        pages = ans.get("relevant_pages") or []
        ph = g["gold_page"] in pages
        page_hits += bool(ph)
        per_q.append({
            "question": g["question"], "schema": g["schema"],
            "gold": gold, "got": got, "score": score, "page_hit": ph,
        })
    n = len(GOLDEN_QA)
    return {
        "value_accuracy": round(hits / n, 4),
        "page_hit": round(page_hits / n, 4),
        "n": n,
        "per_question": per_q,
    }
