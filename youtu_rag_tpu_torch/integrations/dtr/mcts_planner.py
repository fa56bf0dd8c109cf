"""MCTS plan search for deep-table reasoning.

Counterpart of the reference's DTR MCTS planner
(``integrations/DTR/src/modules/mcts_planner.py``, 507 LoC): analysis
plans form a tree; UCT selection picks the most promising plan, expansion
asks the LLM for a refinement informed by rollout feedback, rollouts
execute the plan's pandas code and the reward evaluator scores the
outcome, and rewards backpropagate to bias future selection.

The planner is policy-agnostic: callers inject ``propose`` (plan
refinement) and ``rollout`` (plan execution + reward), so tests drive it
with deterministic fakes and the ExcelAgent wires in its LLM + sandbox.

The port's copy of ``youtu_rag_tpu/integrations/dtr/mcts_planner.py``.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Any, Awaitable, Callable

from ...utils.log import get_logger

logger = get_logger("dtr.mcts")

Propose = Callable[[list[str], str], Awaitable[list[str]]]  # (parent_plan, feedback) -> plan
Rollout = Callable[[list[str]], Awaitable[tuple[float, Any]]]  # plan -> (reward, payload)


@dataclass
class PlanNode:
    plan: list[str]
    parent: "PlanNode | None" = None
    children: list["PlanNode"] = field(default_factory=list)
    visits: int = 0
    value: float = 0.0  # cumulative reward
    reward: float | None = None  # this node's own rollout reward
    payload: Any = None  # rollout artifact (executed steps)
    feedback: str = ""  # rollout summary used to steer refinements

    @property
    def mean(self) -> float:
        return self.value / self.visits if self.visits else 0.0

    def uct(self, c: float) -> float:
        if self.visits == 0:
            return float("inf")
        assert self.parent is not None
        return self.mean + c * math.sqrt(math.log(self.parent.visits + 1) / self.visits)


class MCTSPlanner:
    """UCT search over analysis plans.

    iterations: rollout budget (each iteration executes ONE plan);
    c_uct: exploration constant;
    max_children: refinement branching per node;
    early_stop: stop when a rollout reaches this reward."""

    def __init__(
        self,
        propose: Propose,
        rollout: Rollout,
        *,
        iterations: int = 4,
        c_uct: float = 1.2,
        max_children: int = 2,
        early_stop: float = 0.999,
        parallel: int = 1,
    ):
        self.propose = propose
        self.rollout = rollout
        self.iterations = iterations
        self.c_uct = c_uct
        self.max_children = max_children
        self.early_stop = early_stop
        self.parallel = max(parallel, 1)

    async def search(self, initial_plans: list[list[str]]) -> PlanNode:
        """Run the budgeted search; returns the best rolled-out node.

        With ``parallel > 1``, each round selects up to that many DISTINCT
        nodes (virtual-loss marking keeps UCT from handing back the same
        node) and rolls them out concurrently via ``asyncio.gather`` — the
        multi-path execution form of the reference
        (``smg_module.execute_paths``). Callers must supply a rollout
        that is safe to run concurrently (the ExcelAgent gives each
        rollout its own SheetStateMachine sharing one prefix cache)."""
        import asyncio

        root = PlanNode(plan=[])
        root.children = [PlanNode(plan=p, parent=root) for p in initial_plans if p]
        if not root.children:
            raise ValueError("MCTS needs at least one initial plan")

        best: PlanNode | None = None
        done = 0
        while done < self.iterations:
            k = min(self.parallel, self.iterations - done)
            batch: list[PlanNode] = []
            for _ in range(k):
                node = await self._select_or_expand(root)
                node.visits += 1  # virtual loss: steer later picks away
                batch.append(node)
            results = await asyncio.gather(*(self.rollout(n.plan) for n in batch))
            stop = False
            for node, (reward, payload) in zip(batch, results):
                node.visits -= 1  # revert the virtual loss
                node.reward, node.payload = reward, payload
                node.feedback = f"reward={reward:.2f}"
                self._backprop(node, reward)
                if best is None or reward > (best.reward or -1.0):
                    best = node
                logger.info(
                    "mcts iter %d: reward %.2f (plan %d steps)",
                    done, reward, len(node.plan),
                )
                done += 1
                stop = stop or reward >= self.early_stop
            if stop:
                break
        assert best is not None
        return best

    async def _select_or_expand(self, root: PlanNode) -> PlanNode:
        node = root
        while True:
            unvisited = [c for c in node.children if c.visits == 0]
            if unvisited:
                return unvisited[0]
            if node.children and (
                node is root or len(node.children) >= self.max_children
            ):
                node = max(node.children, key=lambda c: c.uct(self.c_uct))
                continue
            # leaf that has been rolled out → expand with a refinement
            base = node if node is not root else max(root.children, key=lambda c: c.mean)
            refined = await self.propose(base.plan, base.feedback)
            child = PlanNode(plan=refined or base.plan, parent=base)
            base.children.append(child)
            return child

    @staticmethod
    def _backprop(node: PlanNode, reward: float) -> None:
        cur: PlanNode | None = node
        while cur is not None:
            cur.visits += 1
            cur.value += reward
            cur = cur.parent

    @staticmethod
    def top_rollouts(any_node: PlanNode, n: int = 3) -> list[PlanNode]:
        """All rolled-out nodes of the tree containing ``any_node``,
        ranked by reward (best first). Feeds the answer generator's
        cross-path verification section (ref smg_module.execute_paths
        returning all_results alongside best_path)."""
        root = any_node
        while root.parent is not None:
            root = root.parent
        rolled: list[PlanNode] = []

        def walk(x: PlanNode):
            if x.reward is not None:
                rolled.append(x)
            for c in x.children:
                walk(c)

        walk(root)
        rolled.sort(key=lambda x: -(x.reward or 0.0))
        return rolled[:n]

    @staticmethod
    def stats(root_children_or_best: PlanNode) -> dict:
        """Small tree summary for tracing."""
        n = root_children_or_best
        while n.parent is not None:
            n = n.parent
        count = [0]

        def walk(x: PlanNode):
            count[0] += 1
            for c in x.children:
                walk(c)

        walk(n)
        return {"nodes": count[0] - 1, "root_visits": n.visits}
