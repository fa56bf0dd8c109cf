"""The DTR Excel-QA benchmark's scripted analyst and judge: the port's
copy of ``scripts/bench_dtr.py``'s fixture generators, ``ScriptedAnalyst``,
rule function and ``gold_matches``, with a per-question runner.

``ScriptedAnalyst`` writes pandas from the schema brief in each prompt
and the question alone (never from the generators or the gold values);
``make_rule_fn`` serves it to the ``ExcelAgent`` as a ``FakeChatClient``
rule, and holds the decompositions of the multi-hop questions back until
a planner asks for a refinement (the first one flawed), so the three
planners separate as the script's report shows. ``run_question`` drives
one question through a planner and returns what a twin comparison reads:
the answer, the plans, the step code, the event sequence, the LLM calls
and ``evaluate_plan``'s depth reward.

``chip_smoke.py`` phase 4j runs the committed fixture's questions
(``benchmarks/data/dtr/``) through it on the card and on a CPU twin.
pandas is imported inside the functions that use it."""

from __future__ import annotations

import json
import re

_REGIONS = ["north", "south", "east", "west"]
_PRODUCTS = ["gizmo", "widget", "sprocket", "flange", "bracket", "coupling"]
_CATEGORIES = {"gizmo": "gadgets", "widget": "gadgets", "sprocket": "hardware",
               "flange": "hardware", "bracket": "fixtures", "coupling": "fixtures"}
_SITES = ["Arden", "Blackrock", "Calder", "Dunmore", "Eastgate"]
_COUNTRIES = {"Arden": "Norway", "Blackrock": "Chile", "Calder": "Norway",
              "Dunmore": "Canada", "Eastgate": "Chile"}


def gen_workbooks(rng, n_orders: int = 120):
    """The two workbooks as dicts of DataFrames by sheet name. The
    default ``n_orders`` with ``default_rng(23)`` gives the committed
    fixture (``benchmarks/data/dtr/``); a larger ``n_orders`` draws the same
    schema at that many ``orders`` rows."""
    import pandas as pd

    orders = pd.DataFrame({
        "region": [(_REGIONS[int(rng.integers(0, 4))]) for _ in range(n_orders)],
        "product": [(_PRODUCTS[int(rng.integers(0, 6))]) for _ in range(n_orders)],
        "qty": [int(rng.integers(1, 40)) for _ in range(n_orders)],
        "revenue": [int(rng.integers(50, 5000)) for _ in range(n_orders)],
        "quarter": [f"Q{int(rng.integers(1, 5))}" for _ in range(n_orders)],
    })
    products = pd.DataFrame({
        "product": _PRODUCTS,
        "category": [_CATEGORIES[p] for p in _PRODUCTS],
        "unit_cost": [round(float(rng.uniform(2, 120)), 2) for _ in _PRODUCTS],
    })
    staff = pd.DataFrame({
        "rep": [f"rep_{i:02d}" for i in range(12)],
        "region": [_REGIONS[i % 4] for i in range(12)],
        "deals": [int(rng.integers(1, 60)) for _ in range(12)],
    })
    incidents = pd.DataFrame({
        "site": [(_SITES[int(rng.integers(0, 5))]) for _ in range(60)],
        "severity": [["low", "medium", "high"][int(rng.integers(0, 3))] for _ in range(60)],
        "hours_lost": [int(rng.integers(1, 90)) for _ in range(60)],
        "month": [f"2025-{int(rng.integers(1, 13)):02d}" for _ in range(60)],
    })
    sites = pd.DataFrame({
        "site": _SITES,
        "country": [_COUNTRIES[s] for s in _SITES],
        "headcount": [int(rng.integers(40, 900)) for _ in _SITES],
    })
    return {
        "wb_sales": {"orders": orders, "products": products, "staff": staff},
        "wb_ops": {"incidents": incidents, "sites": sites},
    }


def gen_questions(wbs) -> list[dict]:
    """Questions + pandas-computed gold values (never shown to the agent)."""
    sales, ops = wbs["wb_sales"], wbs["wb_ops"]
    orders, products, staff = sales["orders"], sales["products"], sales["staff"]
    incidents, sites = ops["incidents"], ops["sites"]
    qs: list[dict] = []

    def add(wb, question, gold, kind):
        qs.append({"workbook": wb, "question": question,
                   "gold": gold, "kind": kind})

    # lookups (products / sites)
    for p in _PRODUCTS[:4]:
        add("wb_sales", f"What is the unit_cost of product '{p}'?",
            float(products.loc[products["product"] == p, "unit_cost"].iloc[0]),
            "lookup")
    for s in _SITES[:3]:
        add("wb_ops", f"What is the headcount at site '{s}'?",
            int(sites.loc[sites["site"] == s, "headcount"].iloc[0]), "lookup")

    # filtered aggregations
    for r in _REGIONS:
        add("wb_sales", f"What is the total revenue in region '{r}'?",
            int(orders.loc[orders["region"] == r, "revenue"].sum()), "aggregate")
    for sev in ("high", "medium"):
        add("wb_ops", f"What is the total hours_lost for severity '{sev}' incidents?",
            int(incidents.loc[incidents["severity"] == sev, "hours_lost"].sum()),
            "aggregate")
    add("wb_sales", "What is the average qty in region 'north'?",
        round(float(orders.loc[orders["region"] == "north", "qty"].mean()), 2),
        "aggregate")
    for q_ in ("Q1", "Q3"):
        add("wb_sales", f"What is the total revenue in quarter '{q_}'?",
            int(orders.loc[orders["quarter"] == q_, "revenue"].sum()), "aggregate")

    # group-by superlatives
    add("wb_sales", "Which region has the highest total revenue?",
        str(orders.groupby("region")["revenue"].sum().idxmax()), "superlative")
    add("wb_sales", "Which product has the highest total qty?",
        str(orders.groupby("product")["qty"].sum().idxmax()), "superlative")
    add("wb_sales", "Which rep has the highest deals?",
        str(staff.loc[staff["deals"].idxmax(), "rep"]), "superlative")
    add("wb_ops", "Which site has the highest total hours_lost?",
        str(incidents.groupby("site")["hours_lost"].sum().idxmax()), "superlative")

    # cross-sheet joins
    m = orders.merge(products, on="product")
    for c in ("gadgets", "hardware", "fixtures"):
        add("wb_sales", f"What is the total revenue for category '{c}'?",
            int(m.loc[m["category"] == c, "revenue"].sum()), "join")
    mi = incidents.merge(sites, on="site")
    for c in ("Norway", "Chile"):
        add("wb_ops", f"What is the total hours_lost in country '{c}'?",
            int(mi.loc[mi["country"] == c, "hours_lost"].sum()), "join")
    add("wb_sales",
        "Which category has the highest total revenue?",
        str(m.groupby("category")["revenue"].sum().idxmax()), "join")

    # chart requests (judged on the underlying aggregates being produced)
    g = orders.groupby("region")["revenue"].sum()
    add("wb_sales", "Plot total revenue per region as a bar chart.",
        int(g.max()), "chart")
    g2 = incidents.groupby("severity")["hours_lost"].sum()
    add("wb_ops", "Chart the total hours_lost by severity.",
        int(g2.max()), "chart")

    # extra simple tiers (VERDICT r4 item 6: ≥100 questions) ---------------
    for p in _PRODUCTS[4:]:
        add("wb_sales", f"What is the unit_cost of product '{p}'?",
            float(products.loc[products["product"] == p, "unit_cost"].iloc[0]),
            "lookup")
    for s in _SITES[3:]:
        add("wb_ops", f"What is the headcount at site '{s}'?",
            int(sites.loc[sites["site"] == s, "headcount"].iloc[0]), "lookup")
    for s in _SITES:
        add("wb_ops", f"What is the country of site '{s}'?",
            _COUNTRIES[s], "lookup")
    for i in range(0, 12, 2):
        rep = staff.rep[i]
        add("wb_sales", f"What is the deals of rep '{rep}'?",
            int(staff.deals[i]), "lookup")
    for p in _PRODUCTS:
        add("wb_sales", f"What is the total revenue for product '{p}'?",
            int(orders.loc[orders["product"] == p, "revenue"].sum()), "aggregate")
    for q_ in ("Q2", "Q4"):
        add("wb_sales", f"What is the total qty in quarter '{q_}'?",
            int(orders.loc[orders["quarter"] == q_, "qty"].sum()), "aggregate")
    for s in _SITES:
        add("wb_ops", f"What is the total hours_lost at site '{s}'?",
            int(incidents.loc[incidents["site"] == s, "hours_lost"].sum()),
            "aggregate")
    for r in ("south", "east"):
        add("wb_sales", f"What is the average revenue in region '{r}'?",
            round(float(orders.loc[orders["region"] == r, "revenue"].mean()), 2),
            "aggregate")
    add("wb_sales", "Which quarter has the highest total revenue?",
        str(orders.groupby("quarter")["revenue"].sum().idxmax()), "superlative")
    add("wb_ops", "Which severity has the highest total hours_lost?",
        str(incidents.groupby("severity")["hours_lost"].sum().idxmax()),
        "superlative")
    add("wb_sales", "Which product has the highest total revenue?",
        str(orders.groupby("product")["revenue"].sum().idxmax()), "superlative")
    m2 = orders.merge(products, on="product")
    for c in ("gadgets", "hardware", "fixtures"):
        add("wb_sales", f"What is the total qty for category '{c}'?",
            int(m2.loc[m2["category"] == c, "qty"].sum()), "join")
    add("wb_ops", "What is the total hours_lost in country 'Canada'?",
        int(mi.loc[mi["country"] == "Canada", "hours_lost"].sum()), "join")
    g3 = orders.groupby("product")["qty"].sum()
    add("wb_sales", "Plot total qty per product as a bar chart.",
        int(g3.max()), "chart")
    for q_ in ("Q1", "Q2", "Q3", "Q4"):
        add("wb_sales", f"What is the average revenue in quarter '{q_}'?",
            round(float(orders.loc[orders["quarter"] == q_, "revenue"].mean()), 2),
            "aggregate")
    for r in _REGIONS:
        add("wb_sales", f"What is the total qty in region '{r}'?",
            int(orders.loc[orders["region"] == r, "qty"].sum()), "aggregate")
    for s in _SITES:
        add("wb_ops", f"What is the average hours_lost at site '{s}'?",
            round(float(incidents.loc[incidents["site"] == s, "hours_lost"].mean()), 2),
            "aggregate")
    add("wb_ops", "What is the total headcount across all sites?",
        int(sites["headcount"].sum()), "aggregate")
    add("wb_sales", "What is the average unit_cost across all products?",
        round(float(products["unit_cost"].mean()), 2), "aggregate")
    add("wb_sales", "What is the total deals across all staff?",
        int(staff["deals"].sum()), "aggregate")

    # hard multi-hop questions (two aggregates, ratios, median splits) —
    # the tier that differentiates planners, like the reference's
    # sub-100% Excel-QA rows. Worded as templates the scripted analyst's
    # decomposition library keys on (see ScriptedAnalyst.decompose).
    def pct(frame, col, lit, measure):
        return round(100 * frame.loc[frame[col] == lit, measure].sum()
                     / frame[measure].sum(), 1)

    for r in _REGIONS:
        add("wb_sales",
            f"What percentage of total revenue comes from region '{r}'? "
            "Give one decimal.", pct(orders, "region", r, "revenue"), "hard")
    for q_ in ("Q1", "Q3"):
        add("wb_sales",
            f"What percentage of total revenue comes from quarter '{q_}'? "
            "Give one decimal.", pct(orders, "quarter", q_, "revenue"), "hard")
    for sev in ("high", "medium", "low"):
        add("wb_ops",
            f"What percentage of total hours_lost comes from severity "
            f"'{sev}'? Give one decimal.",
            pct(incidents, "severity", sev, "hours_lost"), "hard")
    for r in _REGIONS:
        rev_r = orders.loc[orders["region"] == r, "revenue"].sum()
        deals_r = staff.loc[staff["region"] == r, "deals"].sum()
        add("wb_sales",
            f"What is the revenue per deal in region '{r}' (total revenue "
            "divided by total deals)? Round to 2 decimals.",
            round(float(rev_r) / float(deals_r), 2), "hard")
    qrev = orders.groupby("quarter")["revenue"].sum()
    add("wb_sales",
        "Which quarter had the largest increase in total revenue over the "
        "previous quarter?", str(qrev.diff().idxmax()), "hard")
    mrev = incidents.groupby("month")["hours_lost"].sum()
    add("wb_ops",
        "Which month had the largest increase in total hours_lost over the "
        "previous month?", str(mrev.diff().idxmax()), "hard")
    med = products["unit_cost"].median()
    expensive = set(products.loc[products["unit_cost"] > med, "product"])
    sub = orders[orders["product"].isin(expensive)]
    add("wb_sales",
        "Among products with unit_cost above the median, which has the "
        "highest total qty?",
        str(sub.groupby("product")["qty"].sum().idxmax()), "hard")
    cheap = set(products.loc[products["unit_cost"] < med, "product"])
    sub2 = orders[orders["product"].isin(cheap)]
    add("wb_sales",
        "Among products with unit_cost below the median, which has the "
        "highest total revenue?",
        str(sub2.groupby("product")["revenue"].sum().idxmax()), "hard")
    mh = incidents.merge(sites, on="site")
    per_head = (mh.groupby("country")["hours_lost"].sum()
                / sites.groupby("country")["headcount"].sum())
    add("wb_ops",
        "Which country has the highest total hours_lost per unit of "
        "headcount?", str(per_head.idxmax()), "hard")
    return qs


# ------------------------------------------------------------------ scripted analyst

_STOP = {"the", "a", "an", "of", "for", "in", "on", "at", "is", "are", "what",
         "which", "has", "have", "with", "to", "was", "by", "per", "as",
         "does", "did", "total", "average", "highest", "most", "plot", "chart",
         "bar", "incidents", "items"}

_SYN = {"revenue": ["revenue"], "qty": ["qty", "quantity"], "cost": ["cost"],
        "hours": ["hours", "lost"], "deals": ["deals"], "headcount": ["headcount"]}


def _words(text: str) -> list[str]:
    return [w for w in re.findall(r"[a-z0-9_]+", text.lower()) if w not in _STOP]


class ScriptedAnalyst:
    """Deterministic pandas author for the ExcelAgent prompt protocol.

    Like the text2sql scripted author: it writes analysis code from ONLY
    the schema brief in the prompt plus the question — never from the
    fixture generators or gold values."""

    def parse_brief(self, prompt: str) -> dict[str, dict[str, dict]]:
        sheets: dict[str, dict[str, dict]] = {}
        cur = None
        for line in prompt.splitlines():
            m = re.match(r"- (\w+): \d+ rows x \d+ cols", line)
            if m:
                cur = m.group(1)
                sheets[cur] = {}
                continue
            m = re.match(r"\s+columns: (.+)$", line)
            if m and cur:
                for cm in re.finditer(r"(\w+) \(([^)]*)\)", m.group(1)):
                    inner = cm.group(2)
                    semantic = inner.split(";")[0].strip()
                    vals = []
                    vm = re.search(r"values: (.+)$", inner)
                    if vm:
                        vals = [v.strip() for v in vm.group(1).split(",") if v.strip()]
                    sheets[cur][cm.group(1)] = {"semantic": semantic, "values": vals}
        return sheets

    def _bind_literal(self, sheets, lit: str) -> tuple[str, str] | None:
        for sheet, cols in sheets.items():
            for col, info in cols.items():
                if lit in info["values"]:
                    return sheet, col
        # month/quarter style literals may not be in top-values; bind by
        # shape to a categorical column whose values share a prefix
        for sheet, cols in sheets.items():
            for col, info in cols.items():
                if info["semantic"] == "categorical" and any(
                    v[:1] == lit[:1] for v in info["values"]
                ):
                    return sheet, col
        return None

    def _measure(self, sheets, words, exclude=()) -> tuple[str, str] | None:
        expanded = set(words)
        for w in words:
            expanded.update(_SYN.get(w, ()))
            expanded.update(w.split("_"))  # unit_cost asks match unit_cost cols
        best, score = None, 0
        for sheet, cols in sheets.items():
            for col, info in cols.items():
                if col in exclude or info["semantic"] != "numeric":
                    continue
                s = len(set(col.lower().split("_")) & expanded)
                if s > score:
                    best, score = (sheet, col), s
        return best

    @staticmethod
    def _join_code(sheets, a: str, b: str) -> tuple[str, str]:
        """merge expression + result frame name over the shared column."""
        common = set(sheets[a]) & set(sheets[b])
        key = sorted(common)[0] if common else None
        expr = (
            f"m = dfs['{a}'].merge(dfs['{b}'], on='{key}')"
            if key else f"m = dfs['{a}']"
        )
        return expr, "m"

    def author(self, question: str, prompt: str) -> str:
        sheets = self.parse_brief(prompt)
        if not sheets:
            return "print('no schema visible')"
        ql = question.lower()
        words = _words(question)
        lits = re.findall(r"'([^']+)'", question)

        where = None
        for lit in lits:
            bound = self._bind_literal(sheets, lit)
            if bound:
                where = (bound[0], bound[1], lit)
                break

        agg = "sum" if re.search(r"\btotal\b", ql) else (
            "mean" if re.search(r"\baverage\b", ql) else None)
        superlative = re.search(r"(?:which|what) (\w+) has the (?:highest|most|largest)", ql)
        chart = re.search(r"\b(plot|chart|graph)\b", ql)

        if superlative and not chart:
            group_col = superlative.group(1)
            # locate the grouping column and the measure
            gloc = next(((s, c) for s, cols in sheets.items() for c in cols
                         if c == group_col or group_col in c), None)
            meas = self._measure(sheets, words, exclude=(group_col,))
            if gloc and meas:
                gs, gc = gloc
                ms, mc = meas
                if gs == ms:
                    return (f"g = dfs['{gs}'].groupby('{gc}')['{mc}'].sum()\n"
                            "print(g.idxmax(), g.max())")
                expr, frame = self._join_code(sheets, ms, gs)
                return (f"{expr}\n"
                        f"g = {frame}.groupby('{gc}')['{mc}'].sum()\n"
                        "print(g.idxmax(), g.max())")
            if gloc:  # direct row max (e.g. which rep has the highest deals)
                gs, gc = gloc
                meas2 = self._measure(sheets, words)
                if meas2 and meas2[0] == gs:
                    return (f"r = dfs['{gs}'].loc[dfs['{gs}']['{meas2[1]}'].idxmax()]\n"
                            "print(r.to_dict())")
            return "print('cannot identify grouping')"

        if chart:
            # group the measure by the named dimension and print the data
            # (offline chart: values + a spec line, no display backend)
            meas = self._measure(sheets, words)
            dim = None
            m = re.search(r"(?:per|by) (\w+)", ql)
            if m:
                dim = m.group(1)
            if meas and dim:
                s, c = meas
                gc = next((col for col in sheets[s] if dim in col), None)
                if gc:
                    return (f"g = dfs['{s}'].groupby('{gc}')['{c}'].sum()\n"
                            "print(g.to_dict())\n"
                            f"print('bar chart: {gc} vs {c}')")
            return "print('cannot chart')"

        if agg:
            meas = self._measure(sheets, words)
            if meas is None:
                return "print('no measure found')"
            ms, mc = meas
            if where is None:
                return f"print(dfs['{ms}']['{mc}'].{agg}())"
            ws, wc, lit = where
            if ws == ms:
                return (f"sel = dfs['{ms}'][dfs['{ms}']['{wc}'] == '{lit}']\n"
                        f"print(round(sel['{mc}'].{agg}(), 2))")
            expr, frame = self._join_code(sheets, ms, ws)
            return (f"{expr}\n"
                    f"sel = {frame}[{frame}['{wc}'] == '{lit}']\n"
                    f"print(round(sel['{mc}'].{agg}(), 2))")

        # lookup: what is the <col> of/at <entity>
        if where is not None:
            ws, wc, lit = where
            target = self._measure(sheets, words) or (None, None)
            if target[0] and target[0] != ws:
                # the asked-for column lives in another sheet: rebind the
                # literal there if its values match, else join the sheets
                ts = target[0]
                rebound = next(
                    (c for c, info in sheets[ts].items() if lit in info["values"]),
                    None,
                )
                if rebound:
                    ws, wc = ts, rebound
                else:
                    expr, frame = self._join_code(sheets, ts, ws)
                    return (f"{expr}\n"
                            f"sel = {frame}[{frame}['{wc}'] == '{lit}']\n"
                            f"print(sel['{target[1]}'].iloc[0])")
            if target[0] == ws and target[1]:
                return (f"sel = dfs['{ws}'][dfs['{ws}']['{wc}'] == '{lit}']\n"
                        f"print(sel['{target[1]}'].iloc[0])")
            # print the whole matching row
            return f"print(dfs['{ws}'][dfs['{ws}']['{wc}'] == '{lit}'].to_dict('records'))"
        return "print('unhandled question')"

    # -- decomposition library (plan-level knowledge) -----------------------
    #
    # Multi-hop questions exceed the single-program author above: its one
    # code block computes a partial quantity (e.g. the numerator of a
    # percentage). The knowledge of how to DECOMPOSE them surfaces only
    # when a planner asks for it — MCTS's refine prompt, the autonomous
    # loop's iteration — which is exactly the reference's planner story
    # (mcts_planner.py / smg_autonomous.py vs the linear fast mode).
    # decompose() returns (steps, step→code, flawed_first_code): the
    # FIRST refinement a planner receives is the flawed variant (a
    # plausible misremembered column → KeyError), so search must use
    # rollout rewards to find the correct one, not just ask once.

    _MEASURE_SHEET = {"revenue": "orders", "qty": "orders",
                      "hours_lost": "incidents", "deals": "staff"}

    def decompose(
        self, question: str
    ) -> tuple[list[str], dict[str, str], str] | None:
        q = question
        m = re.match(r"What percentage of total (\w+) comes from (\w+) '([^']+)'", q)
        if m:
            measure, col, lit = m.groups()
            sheet = self._MEASURE_SHEET[measure]
            steps = [
                f"compute part_total = the total {measure} in {sheet} "
                f"where {col} is '{lit}'",
                f"compute grand_total = the overall total {measure} in {sheet}",
                "report 100 * part_total / grand_total rounded to one decimal",
            ]
            codes = {
                steps[0]: (
                    f"part_total = dfs['{sheet}'].loc["
                    f"dfs['{sheet}']['{col}'] == '{lit}', '{measure}'].sum()\n"
                    "print('part:', part_total)"
                ),
                steps[1]: (
                    f"grand_total = dfs['{sheet}']['{measure}'].sum()\n"
                    "print('grand:', grand_total)"
                ),
                steps[2]: "print(round(100 * part_total / grand_total, 1))",
            }
            flawed = codes[steps[0]].replace(f"'{measure}']", f"'{measure}_amt']")
            return steps, codes, flawed
        m = re.match(r"What is the revenue per deal in region '([^']+)'", q)
        if m:
            lit = m.group(1)
            steps = [
                f"compute rev_total = the total revenue in orders where region is '{lit}'",
                f"compute deal_total = the total deals in staff where region is '{lit}'",
                "report rev_total / deal_total rounded to two decimals",
            ]
            codes = {
                steps[0]: (
                    f"rev_total = dfs['orders'].loc["
                    f"dfs['orders']['region'] == '{lit}', 'revenue'].sum()\n"
                    "print('rev:', rev_total)"
                ),
                steps[1]: (
                    f"deal_total = dfs['staff'].loc["
                    f"dfs['staff']['region'] == '{lit}', 'deals'].sum()\n"
                    "print('deals:', deal_total)"
                ),
                steps[2]: "print(round(rev_total / deal_total, 2))",
            }
            flawed = codes[steps[0]].replace("'revenue']", "'sales']")
            return steps, codes, flawed
        m = re.match(r"Which (\w+) had the largest increase in total (\w+) over the", q)
        if m:
            dim, measure = m.groups()
            sheet = self._MEASURE_SHEET[measure]
            steps = [
                f"group {sheet} by {dim} and sum {measure}, store as series_g",
                "report the entry of series_g with the largest increase "
                "over the previous one",
            ]
            codes = {
                steps[0]: (
                    f"series_g = dfs['{sheet}'].groupby('{dim}')"
                    f"['{measure}'].sum().sort_index()\n"
                    "print(series_g.to_dict())"
                ),
                steps[1]: "print(series_g.diff().idxmax())",
            }
            flawed = codes[steps[0]].replace(f"['{measure}']", f"['{measure}_net']")
            return steps, codes, flawed
        m = re.match(
            r"Among products with unit_cost (above|below) the median, "
            r"which has the highest total (\w+)\?", q,
        )
        if m:
            side, measure = m.groups()
            op = ">" if side == "above" else "<"
            steps = [
                f"select products with unit_cost {side} the median, "
                "store their names as picked",
                f"group orders restricted to picked by product and sum {measure}, "
                "store as series_p",
                "report the index of the maximum of series_p",
            ]
            codes = {
                steps[0]: (
                    "med = dfs['products']['unit_cost'].median()\n"
                    f"picked = set(dfs['products'].loc["
                    f"dfs['products']['unit_cost'] {op} med, 'product'])\n"
                    "print(sorted(picked))"
                ),
                steps[1]: (
                    "series_p = dfs['orders'][dfs['orders']['product'].isin(picked)]"
                    f".groupby('product')['{measure}'].sum()\n"
                    "print(series_p.to_dict())"
                ),
                steps[2]: "print(series_p.idxmax())",
            }
            flawed = codes[steps[0]].replace("'unit_cost']", "'cost_per_unit']")
            return steps, codes, flawed
        if q.startswith("Which country has the highest total hours_lost per unit"):
            steps = [
                "join incidents with sites, group by country and sum hours_lost, "
                "store as hl",
                "group sites by country and sum headcount, store as hc",
                "report the index of the maximum of hl divided by hc",
            ]
            codes = {
                steps[0]: (
                    "hl = dfs['incidents'].merge(dfs['sites'], on='site')"
                    ".groupby('country')['hours_lost'].sum()\n"
                    "print(hl.to_dict())"
                ),
                steps[1]: (
                    "hc = dfs['sites'].groupby('country')['headcount'].sum()\n"
                    "print(hc.to_dict())"
                ),
                steps[2]: "print((hl / hc).idxmax())",
            }
            flawed = codes[steps[0]].replace("'hours_lost']", "'hours']")
            return steps, codes, flawed
        return None

    def flawed(self, question: str) -> tuple[list[str], dict[str, str]] | None:
        """First-refinement variant: same decomposition shape, but the
        first step misremembers a column (KeyError) and every later step
        that builds on it fails — realistic first-draft behavior that the
        rollout reward can detect and UCT can route around."""
        d = self.decompose(question)
        if d is None:
            return None
        steps, codes, flawed_first = d
        steps_f = ["(draft) " + s for s in steps]
        codes_f = {sf: codes[s] for sf, s in zip(steps_f, steps)}
        codes_f[steps_f[0]] = flawed_first
        return steps_f, codes_f


def _form_check(step: str, output: str) -> bool:
    """Scripted stand-in for the LLM evaluator's usefulness judgment: a
    step that asks for a decimal/percentage answered with a bare integer
    sum, or a 'which X' question answered with only numbers, did NOT
    produce a useful result — exactly what a real reward evaluator rejects
    (ref: DTR reward_evaluator usefulness dimension)."""
    sl = step.lower()
    if "decimal" in sl:  # percentage / rounded-ratio steps
        return bool(re.search(r"\d+\.\d", output))
    if sl.startswith("which ") or sl.startswith("among "):
        body = output.split("Error")[0]
        return bool(re.search(r"[A-Za-z_][\w-]*", body))
    return True


def make_rule_fn(analyst: ScriptedAnalyst, state: dict):
    """The scripted model: a ``FakeChatClient`` rule that answers each
    of the agent's prompts for ``state["question"]``."""
    from ..agents.llm import FakeChatClient

    def rule(messages, tools):
        content = (messages[-1].content or "") if messages else ""
        q = state["question"]
        if content.startswith("You are a data analyst planning"):
            # first draft: one step, the question verbatim — the realistic
            # single-shot plan. Decomposition knowledge only surfaces when
            # a planner asks for refinement (below).
            return FakeChatClient.text_response(json.dumps([q]))
        if content.startswith("Improve this spreadsheet analysis plan") or \
                content.startswith("The previous analysis of this question failed"):
            k = state.get("refine_calls", 0)
            state["refine_calls"] = k + 1
            d = analyst.decompose(q)
            if d is None:
                return FakeChatClient.text_response(json.dumps([q]))
            if k == 0:  # first refinement: the plausible-but-flawed draft
                steps, codes = analyst.flawed(q)
            else:
                steps, codes, _ = d
            state.setdefault("step_lib", {}).update(codes)
            return FakeChatClient.text_response(json.dumps(steps))
        if content.startswith("Write pandas code"):
            sm = re.search(r"^Step: (.+)$", content, re.M)
            step = sm.group(1).strip() if sm else q
            lib = state.get("step_lib", {})
            if step in lib:
                return FakeChatClient.text_response(lib[step])
            return FakeChatClient.text_response(analyst.author(q, content))
        if content.startswith("Understand this analysis step"):
            return FakeChatClient.text_response(json.dumps(
                {"goal": q, "input_frames": [], "columns": [],
                 "approach": "scripted"}))
        if content.startswith("Did this step execution succeed"):
            ok = "Error" not in content and "Traceback" not in content
            if ok:
                sm = re.search(r"^Step: (.+)$", content, re.M)
                om = content.split("Output:\n", 1)
                out = om[1].split("\n\nReply JSON", 1)[0] if len(om) > 1 else ""
                ok = _form_check(sm.group(1).strip() if sm else q, out)
            return FakeChatClient.text_response(json.dumps({"success": ok, "reason": "scripted"}))
        if content.startswith("Reflect on why"):
            return FakeChatClient.text_response(
                "```python\n" + analyst.author(q, content) + "\n```")
        if content.startswith("You are reviewing"):
            # batch reward verdicts: one JSON list judged from outputs —
            # the cheap mode keeps the execution heuristic only (no form
            # check), which is exactly its accuracy/cost trade
            n = int(re.search(r"reviewing (\d+)", content).group(1))
            return FakeChatClient.text_response(json.dumps(
                [{"success": True, "reason": "scripted"} for _ in range(n)]))
        if content.startswith("# Autonomous tabular analysis"):
            turn = state.get("auto_turns", 0)
            state["auto_turns"] = turn + 1
            d = analyst.decompose(q)
            if d is not None:
                # the iterative loop walks the decomposition step by step,
                # reacting to its own execution feedback — the structural
                # capability linear's one-shot plan lacks
                steps, codes, _ = d
                if turn < len(steps):
                    return FakeChatClient.text_response(
                        "[CODE]\n" + codes[steps[turn]])
            elif turn == 0:
                return FakeChatClient.text_response(
                    "[CODE]\n" + analyst.author(q, content))
            hist = content.split("History of your previous turns:")[-1]
            hist = hist.split("Output EXACTLY ONE action tag")[0]
            vals = [ln.strip() for ln in hist.splitlines()
                    if ln.strip() and not ln.strip().startswith(("[", "#", "("))]
            return FakeChatClient.text_response(
                "[Final Answer]\n" + (" ; ".join(vals[-4:]) or "no result"))
        if content.startswith("Answer the question") or "analysis results" in content[:80]:
            # scripted answer: quote the evidence block's output lines —
            # the printed results carry the values the judge checks for
            m = re.search(
                r"Analysis evidence[^\n]*\n(.*?)(?:\n\nFrames|\n\nWrite|\nThis is a |\Z)",
                content, re.S,
            )
            evidence = (m.group(1) if m else content).strip()
            # quote each step's printed output (the lines following every
            # "[step N]" header) — that's where the computed values live
            outs, lines = [], evidence.splitlines()
            for i, ln in enumerate(lines):
                if ln.startswith("[step "):
                    buf = []
                    for l2 in lines[i + 1:]:
                        if (l2.startswith("[step ") or not l2.strip()
                                or l2.startswith("Final result table")):
                            break
                        buf.append(l2.strip())
                    outs.append(" ".join(buf))
            answer = " ; ".join(o for o in outs if o) or evidence
            return FakeChatClient.text_response(answer[:400])
        return FakeChatClient.text_response("?")

    return rule


# ------------------------------------------------------------------ judge

def gold_matches(gold, answer: str) -> bool:
    a = answer.lower()
    if isinstance(gold, str):
        return gold.lower() in a
    # numeric: accept int and 2-decimal float spellings
    forms = {f"{gold}", f"{gold:.1f}", f"{gold:.2f}", f"{float(gold)}"}
    if float(gold) == int(gold):
        forms.add(str(int(gold)))
    return any(f in a for f in forms)


def first_of_each_kind(questions: list[dict], n: int = 4) -> list[dict]:
    """The first ``n`` questions of each kind, in file order."""
    seen: dict[str, int] = {}
    out = []
    for q in questions:
        if seen.get(q["kind"], 0) < n:
            seen[q["kind"]] = seen.get(q["kind"], 0) + 1
            out.append(q)
    return out


def event_row(ev) -> tuple:
    """An ``AgentEvent`` without its timestamp."""
    return (ev.type, ev.text, ev.name, ev.arguments, json.dumps(ev.data, sort_keys=True,
                                                                default=str))


async def run_question(q: dict, wb_dir: str, planner: str, *, config=None, device=None,
                       memory_toolkit=None) -> dict:
    """Run one question of the fixture through the Excel agent that
    ``get_agent`` builds from ``config`` (default: a bare ``type: excel``)
    with the scripted analyst and ``planner``, at the benchmark's settings
    (``AGENT_SETTINGS``). ``device`` places a local model the agent builds."""
    from ..agents.factory import get_agent
    from ..agents.llm import FakeChatClient
    from ..integrations.dtr.reward import evaluate_plan

    client = FakeChatClient(rule_fn=make_rule_fn(ScriptedAnalyst(), {"question": q["question"]}))
    agent = get_agent(config if config is not None else {"type": "excel"}, client=client,
                      memory_toolkit=memory_toolkit, device=device,
                      **{**AGENT_SETTINGS, "planner": planner})
    return await drive(agent, q, wb_dir, evaluate_plan)


# the benchmark's agent: 3 rollouts (the single-shot plan, the flawed
# refinement, the correct refinement: UCT must pick by reward, not by luck)
AGENT_SETTINGS = dict(mcts_iterations=3, eval_mode="step", max_steps=4, max_code_retries=1)


async def drive(agent, q: dict, wb_dir: str, evaluate_plan) -> dict:
    """Run ``q`` through a built ``ExcelAgent`` and read what a twin
    comparison reads: the answer (a crash is a wrong answer), whether it
    holds the gold value, the LLM calls, ``evaluate_plan``'s depth reward
    over the executed steps, the plans, the step code and the events."""
    events: list[tuple] = []
    try:
        rec = agent.run_streamed(q["question"], wb_dir)
        async for ev in rec.stream_events():
            events.append(event_row(ev))
        await rec.wait()
        answer = rec.final_output or ""
    except Exception as e:  # noqa: BLE001 - a crash is a wrong answer
        answer = f"error: {e}"
    smg = agent.last_smg
    nodes = list(smg.nodes) if smg is not None else []
    return {
        "question": q["question"],
        "kind": q.get("kind"),
        "answer": answer,
        "hit": gold_matches(q["gold"], answer) if "gold" in q else None,
        "llm_calls": agent.llm_calls,
        "depth": evaluate_plan(nodes, q["question"]) if nodes else None,
        "plans": [e[4] for e in events if e[0] == "plan"],
        "codes": [n.code for n in nodes],
        "events": events,
    }


def accuracy(rows: list[dict]) -> float:
    return sum(bool(r["hit"]) for r in rows) / max(len(rows), 1)


def expected_hit(planner: str, kind: str) -> bool:
    """The committed fixture's known outcome on its first four questions of
    each kind: the linear planner misses the "hard" ones, which need a plan
    refined by its reward; mcts and autonomous answer every one."""
    return not (planner == "linear" and kind == "hard")


_CHART_DIR = re.compile(r"dtr_chart_\w+")


def twin_view(row: dict) -> dict:
    """What two twins' runs of a question must agree on (``drive``'s
    row), with each chart's temporary directory (``dtr_chart_*``) masked."""
    return json.loads(_CHART_DIR.sub("dtr_chart_*", json.dumps(row, default=str)))
