"""DTR ExcelAgent — deep table reasoning over spreadsheets.

Capability counterpart of ``integrations/DTR`` in the reference
(``excel_agent.py:69`` + SMG module, MCTS planner, reward evaluator,
answer generator, multi-sheet loader — 12k LoC of LLM orchestration).
This build keeps the architecture's *stages* and telemetry while
implementing them as one coherent loop:

  load sheets → schema brief → PLAN (step list, re-plannable) →
  per step: CODE (pandas) → EXECUTE (sandboxed subprocess) →
  EVALUATE (reward check; failed steps retried with the error) →
  ANSWER (synthesis from step results)

Streaming events flow through the same TaskRecorder protocol as every
other agent, so the API chat route renders DTR runs unchanged.

The port's copy of ``youtu_rag_tpu/integrations/dtr/excel_agent.py``.
``device`` places the chat client that the agent builds from its config (a
local model, ``provider: local``): ``None`` is the CUDA card, which a host
without one refuses; ``"cpu"`` runs it on the host. A memory toolkit is
given built, on its own device (``VectorMemoryToolkit({"device": ...})``).
"""

from __future__ import annotations

import asyncio
import json
import re
from dataclasses import dataclass
from pathlib import Path

from ...agents.config import AgentConfig
from ...agents.events import AgentEvent, TaskRecorder
from ...agents.llm import BaseChatClient, ChatMessage, Usage, get_chat_client
from ...utils.log import get_logger
from .answer import (
    direct_llm_answer,
    extract_from_original,
    is_error_answer,
    synthesize_answer,
)
from .loader import load_sheets, profile_workbook, workbook_brief
from .reward import evaluate_plan, evaluate_step
from .schema_link import link_sheets_element
from .session_log import DTRSessionLog
from .smg import SMGNode, SheetStateMachine, link_sheets  # noqa: F401 - lexical baseline kept exported

logger = get_logger("dtr.excel")

PLAN_PROMPT = """You are a data analyst planning how to answer a question \
about spreadsheet data.

Sheets available (loaded as pandas DataFrames in `dfs` by sheet name):
{schema}

Question: {question}
{operators}
{experience}
Produce a short ordered plan of concrete analysis steps (max {max_steps}).
Reply JSON only: ["step 1", "step 2", ...]"""

CODE_PROMPT = """Write pandas code for this analysis step.

Sheets are preloaded: `dfs` is a dict of DataFrames by sheet name.
{schema}

{state}

Previous step results:
{context}

Step: {step}
{error_context}
Rules: print() the result; no file or network access; frames created by
previous steps are live — reuse them by name instead of recomputing.
Reply with Python code only (no fences)."""

EVAL_PROMPT = """Did this step execution succeed and produce a useful result?

Step: {step}
Output:
{output}

Reply JSON only: {{"success": true|false, "reason": "..."}}"""

RETRY_PLAN_PROMPT = """The previous analysis of this question failed — \
replan with a DIFFERENT strategy.

Sheets:
{schema}

Question: {question}

Previous plan and outcomes:
{trace}

Failure reason: {reason}

Plan again from a different angle (different grouping/joins/columns, or
simpler direct reads), max {max_steps} steps.
Reply JSON only: ["step 1", "step 2", ...]"""

REFINE_PROMPT = """Improve this spreadsheet analysis plan.

Sheets:
{schema}

Previous plan: {plan}
Rollout feedback: {feedback}

Propose a better plan (different angle or fixed weaknesses), max {max_steps}
steps. Reply with a JSON list of step descriptions only."""

UNDERSTAND_PROMPT = """Understand this analysis step before coding it.

Sheets:
{schema}

{state}

Step: {step}

Reply JSON only:
{{"goal": "...", "input_frames": ["dfs['Sheet1']" or frame names], \
"columns": ["columns you will use"], "approach": "one-line plan"}}"""

STAGED_CODE_PROMPT = """Write pandas code for this analysis step.

Sheets are preloaded: `dfs` is a dict of DataFrames by sheet name.
{schema}

{state}

Step: {step}
Validated understanding: {understanding}
{alignment_note}
Rules: print() the result; no file or network access; frames created by
previous steps are live — reuse them by name instead of recomputing.
Reply with Python code only (no fences)."""

REFLECT_PROMPT = """Reflect on why this analysis code failed, then fix it.

{state}

Step: {step}
Code:
{code}
Output:
{output}
Evaluator reason: {reason}

First reason briefly about the root cause, then reply with the corrected
Python code in a ```python fence."""

AUTONOMOUS_PROMPT = """# Autonomous tabular analysis

You are answering a question about spreadsheet data through an autonomous
iterative process. Decide each turn whether to think, run code, or answer.

Goal: {question}

Sheets (preloaded as `dfs`, a dict of DataFrames by sheet name):
{schema}

{state}

{reference}
History of your previous turns:
{history}

Output EXACTLY ONE action tag and its content:

[THINK]
(reasoning about the data / next move — no code)

[CODE]
(python using `dfs` and any frames your earlier code created; print() what
you learn; frames persist between turns)

[Final Answer]
(the answer: concrete numbers, markdown tables where tabular, cite the
turns that produced the evidence)"""

_ACTION_TAG = re.compile(r"\[\s*(THINK|REFLECT|CODE|Final Answer)\s*\]", re.IGNORECASE)

_JSON_LIST = re.compile(r"\[.*\]", re.DOTALL)
_JSON_OBJ = re.compile(r"\{.*\}", re.DOTALL)
_FENCE = re.compile(r"```(?:python)?\s*(.*?)```", re.DOTALL)

# the step record is the SMG node (state-tracked); old name kept as alias
AnalysisStep = SMGNode


class ExcelAgent:
    def __init__(
        self,
        config: AgentConfig | None = None,
        *,
        client: BaseChatClient | None = None,
        file_path: str | None = None,
        max_steps: int = 6,
        max_code_retries: int = 2,
        exec_timeout: float = 30.0,
        memory_toolkit=None,
        planner: str = "linear",  # "linear" | "mcts" | "autonomous"
        mcts_iterations: int = 4,
        mcts_parallel: int = 1,  # concurrent rollouts (ref execute_paths)
        code_mode: str = "direct",  # "direct" | "staged" (ref: enable_multi_stage)
        experience_path: str | None = None,  # persisted SMG operator memory
        eval_mode: str = "step",  # "step" | "batch" (ref: execute_paths phase-2)
        device=None,
    ):
        self.config = config or AgentConfig()
        self.device = device
        self.client = client or get_chat_client(self.config.model.resolved(), device=device)
        self.file_path = file_path
        self.max_steps = max_steps
        self.max_code_retries = max_code_retries
        self.exec_timeout = exec_timeout
        self.planner = planner
        self.mcts_iterations = mcts_iterations
        self.mcts_parallel = max(mcts_parallel, 1)
        self.code_mode = code_mode
        # "batch": steps execute gated only by the execution heuristic and
        # one LLM call verdicts the whole plan afterwards — an N-step plan
        # pays 1 evaluation call instead of N (ref smg_module
        # execute_paths phases 1-3 / reward_evaluator.evaluate_batch)
        self.eval_mode = eval_mode
        # experience manager (ref: DTR experience_manager): successful
        # analysis plans persist as procedural skills and prime the planner
        self.memory = memory_toolkit
        # context-conditioned operator experience on disk (smg.save_memory)
        self.experience_path = experience_path
        # per-run telemetry (ref dtr_framework: llm_calls/token stats) —
        # reset at _analyze entry so each run reports its own cost
        self.llm_calls = 0
        self.usage = Usage()
        self.last_smg: SheetStateMachine | None = None
        # structured per-run trace (ref dtr_logger.DTRLogger) — rebuilt at
        # every _analyze entry; framework saves it when session_dir is set
        self.last_session: DTRSessionLog | None = None

    # -- sheet loading (ref: multi-sheet loader) ---------------------------

    @staticmethod
    def load_sheets(path: str):
        # header-detecting multi-sheet loader (ref: multi-sheet loader)
        return load_sheets(path)

    @staticmethod
    def load_schema(path: str, question: str | None = None, sheets=None) -> str:
        """Profiled sheet brief for prompting: semantic column types, null
        fractions, categorical top-values (loader.py). With a question and
        many sheets, schema linking ranks sheets/columns so only the
        workbook's relevant corner prompts (ref: DTR schema linking).
        Pass preloaded ``sheets`` to avoid re-reading the workbook."""
        sheets = sheets if sheets is not None else ExcelAgent.load_sheets(path)
        order = list(sheets)
        linked: dict[str, list[str]] = {}
        if question and len(sheets) > 4:
            # element-index linking (idf-weighted sheet/column/value
            # elements) — replaces the lexical-overlap heuristic, which
            # mis-ranks sheets sharing only ubiquitous column words
            # (ref: DTR schema_linking.py:38-542; VERDICT r2 item 4)
            ranked = link_sheets_element(question, sheets, top_n=4)
            order = [name for name, _, _ in ranked]
            linked = {name: cols for name, _, cols in ranked}
        selected = {name: sheets[name] for name in order}
        profiles = profile_workbook(selected)
        joins = None
        if len(order) > 1:
            from .loader import detect_join_keys

            joins = detect_join_keys(selected)
        brief = workbook_brief(profiles, relevant=linked, join_keys=joins)
        if len(order) < len(sheets):
            brief += f"\n({len(sheets) - len(order)} less-relevant sheets omitted)"
        return brief

    # -- LLM helpers -------------------------------------------------------

    async def _chat(self, prompt: str) -> str:
        resp = await self.client.chat([ChatMessage("user", prompt)])
        self.llm_calls += 1
        self.usage.add(resp.usage)
        return resp.message.content or ""

    @staticmethod
    def _code(text: str) -> str:
        m = _FENCE.search(text)
        return (m.group(1) if m else text).strip()

    # -- multi-stage code generation (ref: smg_module stages 1-3) -----------

    @staticmethod
    def _validate_alignment(understanding: dict, smg: SheetStateMachine, schema: str) -> str:
        """Host-side check that the understanding references live frames /
        known columns (ref: _validate_alignment, smg_module.py:1111).
        Returns a correction note for the code prompt ('' when aligned)."""
        notes = []
        known_frames = set(smg.state)
        for f in understanding.get("input_frames", []):
            f = str(f)
            if f.startswith("dfs[") or f == "dfs" or f in known_frames:
                continue
            notes.append(
                f"frame {f!r} does not exist; available: {sorted(known_frames) or ['dfs sheets only']}"
            )
        known_cols = set()
        for st in smg.state.values():
            known_cols.update(st.columns)
        for col in understanding.get("columns", []):
            if str(col) in known_cols or str(col) in schema:
                continue
            notes.append(f"column {col!r} not found in any frame or sheet")
        return ("ALIGNMENT WARNINGS:\n" + "\n".join(f"- {n}" for n in notes)) if notes else ""

    async def _gen_code_staged(
        self, desc: str, smg: SheetStateMachine, schema: str,
        prev_code: str, prev_output: str, prev_reason: str,
    ) -> str:
        """Understand → align-validate → generate; failures route through
        a reflect-and-refine pass instead of a bare retry."""
        if prev_code:  # stage 3: reflect on the failed attempt
            raw = await self._chat(
                REFLECT_PROMPT.format(
                    state=smg.state_summary(), step=desc,
                    code=prev_code, output=prev_output[-600:], reason=prev_reason,
                )
            )
            return self._code(raw)
        raw = await self._chat(
            UNDERSTAND_PROMPT.format(schema=schema, state=smg.state_summary(), step=desc)
        )
        mo = _JSON_OBJ.search(raw)
        understanding: dict = {}
        if mo:
            try:
                understanding = json.loads(mo.group(0))
            except json.JSONDecodeError:
                understanding = {}
        note = self._validate_alignment(understanding, smg, schema) if understanding else ""
        raw = await self._chat(
            STAGED_CODE_PROMPT.format(
                schema=schema,
                state=smg.state_summary(),
                step=desc,
                understanding=json.dumps(understanding, ensure_ascii=False) or "(unparsed)",
                alignment_note=note,
            )
        )
        return self._code(raw)

    # -- the loop ----------------------------------------------------------

    async def run(self, question: str, file_path: str | None = None) -> TaskRecorder:
        recorder = self.run_streamed(question, file_path)
        async for _ in recorder.stream_events():
            pass
        return await recorder.wait()

    def run_streamed(self, question: str, file_path: str | None = None) -> TaskRecorder:
        recorder = TaskRecorder(task=question)

        async def go():
            try:
                answer = await self._analyze(question, file_path or self.file_path, recorder)
                recorder.set_final_output(answer)
                recorder.emit(AgentEvent("final", text=answer))
                recorder.finish()
            except Exception as e:  # noqa: BLE001
                logger.exception("excel agent failed")
                recorder.emit(AgentEvent("error", text=str(e)))
                recorder.finish(error=str(e))

        asyncio.ensure_future(go())
        return recorder

    async def _run_plan(
        self, plan: list[str], smg: SheetStateMachine, schema: str, recorder: TaskRecorder
    ) -> list[SMGNode]:
        """Execute a plan through the sheet-state machine: per step
        code-gen (conditioned on the LIVE frame state, so later steps reuse
        earlier steps' derived frames/joins) → sandbox → reward evaluator,
        with error-driven retries. Unchanged plan prefixes resume from the
        SMG's prefix cache instead of re-executing (MCTS rollout reuse)."""
        session = self.last_session
        path_id = session.new_path_id() if session else ""
        cached = smg.cached_prefix(plan)
        smg.reset_to(cached)
        completed: list[SMGNode] = list(cached)
        if cached:
            recorder.emit(
                AgentEvent("reasoning_delta", text=f"resumed {len(cached)} cached step(s)")
            )
        for desc in plan[len(cached):]:
            node = SMGNode(desc)
            error_context = ""
            last_reason = ""
            state_after: dict = {}
            for attempt in range(self.max_code_retries + 1):
                node.attempts = attempt + 1
                if self.code_mode == "staged":
                    node.code = await self._gen_code_staged(
                        desc, smg, schema,
                        prev_code=node.code if attempt else "",
                        prev_output=node.output if attempt else "",
                        prev_reason=last_reason,
                    )
                else:
                    hints = smg.context_hints(node.description)
                    code_raw = await self._chat(
                        CODE_PROMPT.format(
                            schema=schema,
                            state=smg.state_summary(),
                            context=("\n".join(
                                f"- {s.description}: {s.output[:300]}" for s in completed
                            ) or "(none)") + (f"\n[experience] {hints}" if hints else ""),
                            step=node.description,
                            error_context=error_context,
                        )
                    )
                    node.code = self._code(code_raw)
                recorder.emit(AgentEvent("tool_call", name="pandas_exec", arguments=node.code[:500]))
                node.output, state_after = await smg.execute_step(node.code)
                recorder.emit(AgentEvent("tool_output", name="pandas_exec", text=node.output[:800]))

                # reward evaluation (ref: reward evaluator). In batch
                # eval mode the LLM verdict is deferred to one plan-level
                # call after execution; retries here trigger only on
                # execution errors.
                if self.eval_mode == "batch":
                    verdict = {"success": "Error" not in node.output}
                else:
                    ev_raw = await self._chat(
                        EVAL_PROMPT.format(step=node.description, output=node.output[:1000])
                    )
                    mo = _JSON_OBJ.search(ev_raw)
                    verdict = json.loads(mo.group(0)) if mo else {"success": "Error" not in node.output}
                node.success = bool(verdict.get("success"))
                if node.success:
                    break
                last_reason = str(verdict.get("reason", ""))
                error_context = (
                    f"The previous code failed.\nCode:\n{node.code}\n"
                    f"Output:\n{node.output[-600:]}\nReason: {last_reason}\nFix it."
                )
            smg.record(node, state_after)
            # graded multi-dimension reward (ref: reward evaluator) — the
            # LLM verdict gates success; the heuristics grade quality
            node.reward = evaluate_step(node).total
            completed.append(node)
            smg.cache_prefix([n.description for n in completed], completed)
            if session and self.eval_mode != "batch":
                session.log_operator_execution(
                    path_id, len(completed) - 1, node.description, node.code,
                    node.output, node.success, node.reward, node.attempts,
                )
            recorder.add_message(
                "analyst", f"{node.description} -> {'ok' if node.success else 'failed'}"
            )
        new_nodes = completed[len(cached):]
        if self.eval_mode == "batch" and new_nodes:
            # phase-2 batch verdict: one LLM call for the whole plan (ref
            # smg_module.execute_paths phases 1-3). Success flips update
            # the graded reward; session rows log with final verdicts.
            from .reward import evaluate_batch_llm

            verdicts = await evaluate_batch_llm(new_nodes, self._chat)
            for node, v in zip(new_nodes, verdicts):
                if node.success != v["success"]:
                    node.success = v["success"]
                    node.reward = evaluate_step(node).total
            if session:
                for i, node in enumerate(new_nodes):
                    session.log_operator_execution(
                        path_id, len(cached) + i, node.description, node.code,
                        node.output, node.success, node.reward, node.attempts,
                    )
        if session:
            session.log_path_completion(
                path_id, plan, sum(n.reward for n in completed)
            )
        return completed

    async def _mcts_analyze(
        self,
        plan: list[str],
        smg: SheetStateMachine,
        schema: str,
        recorder: TaskRecorder,
        question: str = "",
        ado=None,
    ) -> list[SMGNode]:
        """Plan-space UCT search (ref: DTR mcts_planner): rollouts execute
        candidate plans, reward = fraction of steps the evaluator accepts,
        refinements come from the LLM conditioned on rollout feedback."""
        from .mcts_planner import MCTSPlanner

        async def propose(parent_plan: list[str], feedback: str) -> list[str]:
            raw = await self._chat(
                REFINE_PROMPT.format(
                    schema=schema,
                    plan=json.dumps(parent_plan, ensure_ascii=False),
                    feedback=feedback or "(first refinement)",
                    max_steps=self.max_steps,
                )
            )
            mm = _JSON_LIST.search(raw)
            refined = [str(s) for s in json.loads(mm.group(0))] if mm else []
            return refined[: self.max_steps] or parent_plan

        async def rollout(p: list[str]) -> tuple[float, list[SMGNode]]:
            # parallel rollouts get isolated machines (reset_to/execute
            # mutate machine state) pooling one prefix cache; serial
            # search keeps the caller's machine for in-place reuse
            machine = (
                smg
                if self.mcts_parallel <= 1
                else SheetStateMachine(
                    smg.path, exec_timeout=self.exec_timeout,
                    prefix_cache=smg._prefix_cache,
                )
            )
            steps = await self._run_plan(p, machine, schema, recorder)
            # graded plan reward (ref: reward evaluator): mean step reward
            # + completion bonus — gives UCT a gradient between rollouts
            # that binary success fractions collapse together
            r = evaluate_plan(steps, question=question)
            if ado is not None:
                # ADO validity bonus: steps inside the decomposed operator
                # set; off-set plans are likely drifting off-question
                r = round(min(r + 0.05 * ado.plan_coverage(p), 1.0), 4)
            return r, steps

        planner = MCTSPlanner(
            propose, rollout, iterations=self.mcts_iterations,
            parallel=self.mcts_parallel,
        )
        best = await planner.search([plan])
        # runner-up rollouts feed the answer prompt's cross-verification
        # section (ref smg_module.execute_paths all_results)
        self._last_alt_paths = [
            {
                "plan": node.plan,
                "reward": node.reward or 0.0,
                "success": sum(1 for s in (node.payload or []) if s.success),
                "total": len(node.payload or []),
                "result": next(
                    (s.output for s in reversed(node.payload or []) if s.success), ""
                ),
            }
            for node in MCTSPlanner.top_rollouts(best, n=4)
            if node is not best
        ][:3]
        # rewind the state machine to the winning rollout: answer-time frame
        # rendering must see the BEST plan's frames, not whichever refinement
        # happened to execute last
        smg.reset_to([n for n in (best.payload or []) if n.success])
        recorder.emit(
            AgentEvent(
                "plan",
                data={
                    "mcts": MCTSPlanner.stats(best),
                    "best_reward": best.reward,
                    "best_plan": best.plan,
                },
            )
        )
        return best.payload or []

    async def _autonomous_analyze(
        self,
        question: str,
        smg: SheetStateMachine,
        schema: str,
        recorder: TaskRecorder,
        reference_plan: list[str] | None = None,
        max_iters: int = 10,
    ) -> str:
        """Plan-free loop (ref: smg_autonomous.py execute_with_autonomous_
        loop): the LLM chooses [THINK]/[CODE]/[Final Answer] each turn;
        code runs through the state machine so frames persist; a reference
        plan (when given) is advisory, not binding; the loop force-closes
        after max_iters with the answer generator."""
        history: list[str] = []
        reference = ""
        if reference_plan:
            reference = (
                "Suggested steps (a REFERENCE — follow or deviate):\n"
                + "\n".join(f"- {s}" for s in reference_plan)
                + "\n"
            )
        for it in range(max_iters):
            raw = await self._chat(
                AUTONOMOUS_PROMPT.format(
                    question=question,
                    schema=schema,
                    state=smg.state_summary(),
                    reference=reference,
                    history="\n".join(history[-12:]) or "(first turn)",
                )
            )
            m = _ACTION_TAG.search(raw)
            action = (m.group(1).upper() if m else "THINK").replace("REFLECT", "THINK")
            content = raw[m.end():].strip() if m else raw.strip()
            if action == "FINAL ANSWER":
                recorder.emit(AgentEvent("final", text=""))
                return content
            if action == "CODE":
                code = self._code(content)
                node = SMGNode(f"autonomous turn {it + 1}", code=code)
                recorder.emit(AgentEvent("tool_call", name="pandas_exec", arguments=code[:500]))
                out, state_after = await smg.execute_step(code)
                node.output = out
                node.success = "Error" not in out
                smg.record(node, state_after)
                node.reward = evaluate_step(node).total
                if self.last_session:
                    self.last_session.log_operator_execution(
                        "autonomous", it, node.description, code,
                        out, node.success, node.reward, 1,
                    )
                recorder.emit(AgentEvent("tool_output", name="pandas_exec", text=out[:800]))
                history.append(f"[turn {it + 1} CODE]\n{code}\n→ {out[:400]}")
                # structured feedback (ref smg_autonomous._build_success_
                # feedback:887 / _build_error_feedback:961): tell the
                # model what frames appeared/changed, or why it failed and
                # what IS live — this is what lets a wrong-column join be
                # corrected next turn instead of repeated
                if node.success:
                    delta = ", ".join(node.new_frames + node.changed_frames) or "no frame changes"
                    history.append(
                        f"[feedback] ok — frames now: {delta}. Build on them by name."
                    )
                else:
                    history.append(
                        "[feedback] FAILED. Fix the error using only live "
                        f"frames/columns.\n{smg.state_summary()[:400]}"
                    )
            else:
                recorder.emit(AgentEvent("reasoning_delta", text=content[:500]))
                history.append(f"[turn {it + 1} THINK] {content[:400]}")
        # iteration budget spent: synthesize from what executed
        return await synthesize_answer(question, smg.nodes, self._chat, smg.state, machine=smg)

    async def _recover_answer(
        self,
        question: str,
        answer: str,
        smg: SheetStateMachine,
        schema: str,
        completed: list[SMGNode],
        recorder: TaskRecorder,
    ) -> str:
        """Recovery ladder for error answers (ref dtr_framework step 4.5:
        retry-with-replanning → direct-LLM answer → extraction from the
        original table). Each rung only replaces the answer when its
        result is a real answer; otherwise the previous one stands."""
        session = self.last_session
        reason = "error answer" if completed else "no steps executed"
        recorder.emit(
            AgentEvent("reasoning_delta", text=f"answer recovery: replanning ({reason})")
        )
        # rung 1: replan from a different angle with the failure trace
        try:
            trace = "\n".join(
                f"- {n.description} -> {'ok' if n.success else 'FAILED'}: {n.output[:150]}"
                for n in completed
            ) or "(no steps ran)"
            raw = await self._chat(
                RETRY_PLAN_PROMPT.format(
                    schema=schema, question=question, trace=trace,
                    reason=reason, max_steps=self.max_steps,
                )
            )
            m = _JSON_LIST.search(raw)
            retry_plan = [str(s) for s in json.loads(m.group(0))][: self.max_steps] if m else []
            if retry_plan:
                recorder.emit(AgentEvent("plan", data={"retry_steps": retry_plan}))
                redone = await self._run_plan(retry_plan, smg, schema, recorder)
                retry_answer = await synthesize_answer(
                    question, redone, self._chat, smg.state, machine=smg
                )
                if not is_error_answer(retry_answer):
                    if session:
                        session.log_recovery("replan", reason, replaced=True)
                    return retry_answer
        except Exception:  # noqa: BLE001 - recovery must not raise past the run
            logger.exception("replanning recovery failed")
        # rung 2: answer straight from the rendered tables (no code)
        recorder.emit(AgentEvent("reasoning_delta", text="answer recovery: direct LLM"))
        direct = await direct_llm_answer(question, smg, self._chat)
        if direct is not None:
            if session:
                session.log_recovery("direct_llm", reason, replaced=True)
            return direct
        # rung 3: permissive extraction from the original table
        extracted = await extract_from_original(question, smg, self._chat)
        if session:
            session.log_recovery("extract_original", reason, replaced=extracted is not None)
        return extracted if extracted is not None else answer

    async def _analyze(self, question: str, path: str | None, recorder: TaskRecorder) -> str:
        if not path or not Path(path).exists():
            raise FileNotFoundError(f"spreadsheet not found: {path}")
        self.llm_calls = 0
        self.usage = Usage()
        session = self.last_session = DTRSessionLog()
        session.log_query(question, path, self.planner)
        sheets = self.load_sheets(path)  # one read serves schema + ADO
        schema = self.load_schema(path, question, sheets=sheets)
        self._last_alt_paths = []
        # linked headers feed the answer prompt's schema hint
        # (ref answer_generator._build_prompt schema_hint :278-292)
        self._schema_hint = ""
        try:
            ranked_sheets = link_sheets_element(question, sheets, top_n=2)
            self._schema_hint = "; ".join(
                f"{name}: {', '.join(cols[:6])}" for name, _, cols in ranked_sheets if cols
            )
        except Exception:  # noqa: BLE001 - the hint is advisory
            logger.exception("schema-hint linking failed")
        smg = SheetStateMachine(path, exec_timeout=self.exec_timeout)
        if self.experience_path:
            smg.load_memory(self.experience_path)
        self.last_smg = smg
        recorder.emit(AgentEvent("reasoning_delta", text=f"loaded sheets:\n{schema[:500]}"))

        # ADO stage (ref ado_module): decompose the question into its
        # operator set before planning — constrains the plan prompt,
        # scores plan validity in the MCTS reward, and serves as the
        # advisory operator reference of the autonomous loop (ref
        # smg_autonomous._build_operator_reference:591)
        from .operators import decompose

        try:
            ado = decompose(question, profile_workbook(sheets))
            recorder.emit(AgentEvent("plan", data={"operators": ado.names}))
            session.log_operator_extraction(question, list(ado.names))
        except Exception:  # noqa: BLE001 - decomposition is advisory
            logger.exception("operator decomposition failed")
            ado = None

        if self.planner == "autonomous":
            reference_plan = list(ado.names) if ado is not None else []
            # experience priming (ref experience_manager): past successful
            # plans join the advisory reference, same as the linear path
            if self.memory is not None:
                try:
                    skills = await self.memory.search_skills(question, top_k=1)
                    if skills and not skills.startswith("No skills"):
                        reference_plan.append(f"(past approach) {skills[:300]}")
                except Exception:  # noqa: BLE001
                    logger.exception("experience retrieval failed")
            answer = await self._autonomous_analyze(
                question, smg, schema, recorder,
                reference_plan=reference_plan or None,
            )
            if is_error_answer(answer):
                answer = await self._recover_answer(
                    question, answer, smg, schema, list(smg.nodes), recorder
                )
            if self.experience_path:
                try:
                    smg.save_memory(self.experience_path)
                except OSError:
                    logger.exception("experience save failed")
            session.log_answer(
                answer, self.llm_calls,
                self.usage.input_tokens + self.usage.output_tokens,
            )
            return answer

        experience = ""
        if self.memory is not None:
            try:
                skills = await self.memory.search_skills(question, top_k=2)
                if skills and not skills.startswith("No skills"):
                    experience = f"\nPast successful approaches:\n{skills}\n"
            except Exception:  # noqa: BLE001
                logger.exception("experience retrieval failed")
        raw = await self._chat(
            PLAN_PROMPT.format(
                schema=schema,
                question=question,
                max_steps=self.max_steps,
                experience=experience,
                operators=f"\n{ado.prompt_block()}\n" if ado is not None else "",
            )
        )
        m = _JSON_LIST.search(raw)
        step_texts = json.loads(m.group(0)) if m else [question]
        plan = [str(s) for s in step_texts[: self.max_steps]]
        recorder.emit(AgentEvent("plan", data={"steps": plan}))
        session.log_plan(self.planner, plan)

        if self.planner == "mcts":
            completed = await self._mcts_analyze(
                plan, smg, schema, recorder, question=question, ado=ado
            )
        else:
            completed = await self._run_plan(plan, smg, schema, recorder)

        recorder.emit(AgentEvent("reasoning_delta", data={"smg": smg.memory_summary()}))
        answer = await synthesize_answer(
            question, completed, self._chat, smg.state, machine=smg,
            alt_paths=self._last_alt_paths, schema_hint=self._schema_hint,
        )
        if is_error_answer(answer) or not any(n.success for n in completed):
            answer = await self._recover_answer(
                question, answer, smg, schema, completed, recorder
            )
        if self.experience_path:
            try:
                smg.save_memory(self.experience_path)
            except OSError:
                logger.exception("experience save failed")
        if self.memory is not None and completed and all(s.success for s in completed):
            try:
                await self.memory.store_skill(
                    name=f"analysis:{question[:40]}",
                    description=f"Successful plan for: {question[:120]}",
                    steps=[s.description for s in completed],
                )
            except Exception:  # noqa: BLE001
                logger.exception("experience store failed")
        session.log_answer(
            answer, self.llm_calls, self.usage.input_tokens + self.usage.output_tokens
        )
        return answer
