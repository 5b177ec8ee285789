"""Chinese financial glossary for query expansion.

Same role and function contracts as the reference's curated glossary
(reference src/financial_glossary.py:5-104): concept entries with
term/definition/aliases/formula, a substring matcher with a top-N
fallback, and a prompt-context formatter.  Entries are standard public
financial definitions written independently.

Port of ``rag_challenge_2_tpu/llm/glossary.py`` (pure host code, unchanged).
"""

from __future__ import annotations

from typing import Dict, List

FINANCIAL_GLOSSARY: List[Dict] = [
    {
        "term": "营业收入",
        "aliases": ["营收", "收入", "销售收入", "主营业务收入"],
        "definition": "企业经营活动中形成的经济利益流入总额。",
        "formula": "营业收入 = 主营业务收入 + 其他业务收入",
    },
    {
        "term": "净利润",
        "aliases": ["净利", "归母净利润", "归属于母公司所有者的净利润", "盈利"],
        "definition": "利润总额扣除所得税费用后的余额。",
        "formula": "净利润 = 利润总额 − 所得税费用",
    },
    {
        "term": "毛利率",
        "aliases": ["销售毛利率", "毛利水平"],
        "definition": "毛利占营业收入的比重，反映产品盈利能力。",
        "formula": "毛利率 = (营业收入 − 营业成本) / 营业收入 × 100%",
    },
    {
        "term": "研发费用",
        "aliases": ["研发投入", "研发支出", "R&D费用"],
        "definition": "企业研究与开发活动中费用化的支出。",
        "formula": "研发费用率 = 研发费用 / 营业收入 × 100%",
    },
    {
        "term": "资产负债率",
        "aliases": ["负债率", "杠杆率"],
        "definition": "负债总额占资产总额的比例，衡量偿债能力与财务风险。",
        "formula": "资产负债率 = 负债总额 / 资产总额 × 100%",
    },
    {
        "term": "经营活动现金流量净额",
        "aliases": ["经营现金流", "经营性现金流净额"],
        "definition": "经营活动产生的现金流入与流出的差额。",
        "formula": "经营现金流净额 = 经营现金流入 − 经营现金流出",
    },
    {
        "term": "净资产收益率",
        "aliases": ["ROE", "股东权益报酬率"],
        "definition": "净利润与平均净资产之比，衡量股东资本的回报水平。",
        "formula": "ROE = 净利润 / 平均净资产 × 100%",
    },
    {
        "term": "应收账款",
        "aliases": ["应收款", "应收账款余额"],
        "definition": "因销售商品或提供劳务而应向购买方收取的款项。",
        "formula": "应收账款周转率 = 营业收入 / 平均应收账款",
    },
    {
        "term": "存货",
        "aliases": ["库存", "存货余额"],
        "definition": "企业持有以备出售的产成品、在产品及材料等。",
        "formula": "存货周转率 = 营业成本 / 平均存货",
    },
    {
        "term": "同比增长率",
        "aliases": ["同比", "同比增速", "YoY"],
        "definition": "本期数较上年同期数的增长幅度。",
        "formula": "同比增长率 = (本期数 − 上年同期数) / 上年同期数 × 100%",
    },
]


def find_financial_concepts(question: str, top_n: int = 3) -> List[Dict]:
    """Substring match on term/aliases; falls back to the first ``top_n``
    entries when nothing matches (reference src/financial_glossary.py:69-89)."""
    matched = [
        e for e in FINANCIAL_GLOSSARY
        if e["term"] in question or any(a in question for a in e["aliases"])
    ]
    return matched[:top_n] if matched else FINANCIAL_GLOSSARY[:top_n]


def format_glossary_context(concepts: List[Dict]) -> str:
    """Concepts → prompt block (reference src/financial_glossary.py:92-104)."""
    lines = []
    for e in concepts:
        lines.append(
            f"- {e['term']}（又称：{'、'.join(e['aliases'])}）：{e['definition']}"
            f" 公式：{e['formula']}"
        )
    return "金融术语参考:\n" + "\n".join(lines) if lines else ""
