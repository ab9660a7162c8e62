"""The "refresh" traffic: the recommendation refresh after a graph update.

Each pass encodes the graph once (`Recommender.encode`, queued without a
wait) and then asks `Recommender.recommend(users, k, exclude_seen)` for
every user, in requests of `request_users` users taken in one order drawn
from the seed; one caller, a closed loop. A request ends when its scores
and ids are on the host, so the first request of a pass waits for the
encode. The window runs whole passes until `seconds` have passed.

Set-up warms up one encode and two requests. After the window a sample of
the finished requests, drawn from the seed with the last one in it, is
held to the reference's top-k from the same weights and log.
"""

from __future__ import annotations

import gc
import time
from typing import Dict, List

import numpy as np
import torch

from benchmark.harness import logs, oracle
from benchmark.harness.stages import Stages
from benchmark.harness.trace import WINDOW_SPAN
from benchmark.harness.weights import make_weights
from benchmark.reference import selfgnn as ref


# the finished requests held to the reference after the window
CHECKED_REQUESTS = 4


def request_order(num_users: int, size: int, seed: int) -> List[np.ndarray]:
    order = np.random.default_rng(int(seed) + 7).permutation(num_users)
    return [order[i:i + size] for i in range(0, num_users, size)]


class Program:
    """The system under test for one refresh run."""

    def __init__(self, cell, seed: int, device: torch.device,
                 **model_overrides):
        from sagnn_tpu_torch.serve import Recommender

        self.cell, self.seed, self.device = cell, int(seed), device
        self.cfg = cell.program_config(seed, **model_overrides)
        clock = Stages()
        self.log = logs.generate(cell.log, seed)
        bundle = logs.bundle(self.log, self.cfg.model.graph_num)
        clock.mark("log")
        weights = make_weights(cell.model, self.log.num_users,
                               self.log.num_items, seed, device)
        clock.mark("weights")
        self.rec = Recommender(self.cfg, bundle, params=weights, device=device)
        clock.mark("recommender")
        self.requests = request_order(self.log.num_users,
                                      int(cell.traffic["request_users"]), seed)
        self.results: List[tuple] = []     # (request index, scores, ids)
        self.encode_s: List[float] = []
        self.rec.encode()
        for users in self.requests[:2]:
            self.ask(users)
        clock.mark("warm-up requests")
        self.stages = clock.seconds

    def ask(self, users: np.ndarray):
        tr = self.cell.traffic
        scores, ids = self.rec.recommend(users, k=int(tr["k"]),
                                         exclude_seen=bool(tr["exclude_seen"]))
        return scores.cpu().numpy(), ids.cpu().numpy().astype(np.int32)

    def window(self, seconds: float, on_device: bool,
               trace: bool = False) -> dict:
        """Whole passes until `seconds` have passed. trace (the traced
        run): each encode is ended by a synchronise and timed."""
        sync = torch.cuda.synchronize if on_device else (lambda: None)
        latencies: List[float] = []
        sync()
        with torch.profiler.record_function(WINDOW_SPAN):
            t0 = time.perf_counter()
            ends = []
            while True:
                e0 = time.perf_counter()
                self.rec.encode()
                if trace:
                    sync()
                    self.encode_s.append(time.perf_counter() - e0)
                for r, users in enumerate(self.requests):
                    a = time.perf_counter()
                    scores, ids = self.ask(users)
                    latencies.append(time.perf_counter() - a)
                    self.results.append((r, scores, ids))
                ends.append(time.perf_counter() - t0)
                if ends[-1] >= seconds:
                    break
            window_s = time.perf_counter() - t0
        return {"window_s": window_s, "passes": len(ends),
                "users": len(ends) * self.log.num_users,
                "rounds_s": list(np.diff([0.0] + ends)),
                "latencies": latencies, "attempted": len(latencies)}

    def release(self) -> None:
        self.rec = None
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()


def p95(values: List[float]) -> float:
    """The 95th percentile, linearly interpolated between order
    statistics."""
    return float(np.percentile(np.asarray(values), 95))


def end_to_end(meas: dict) -> Dict[str, float]:
    return {"serve_users_per_s": meas["users"] / meas["window_s"]}


def layer_context(prog: Program, meas: dict) -> dict:
    return {"requests": len(meas["latencies"]),
            "request_p95_ms": 1e3 * p95(meas["latencies"]),
            "encode_ms": (1e3 * float(np.mean(prog.encode_s))
                          if prog.encode_s else None)}


def sample(n_finished: int, seed: int,
           count: int = CHECKED_REQUESTS) -> List[int]:
    """`count` finished requests drawn from the seed, the last included."""
    rng = np.random.default_rng(int(seed) + 11)
    pick = rng.choice(n_finished - 1, size=min(count, n_finished) - 1,
                      replace=False) if n_finished > 1 else []
    return sorted(set(int(i) for i in pick) | {n_finished - 1})


def user_inputs(log: logs.Log, users: np.ndarray, length: int):
    """Each user's last `length` train items, right-aligned, and the mask."""
    seq = np.zeros((len(users), length), np.int64)
    mask = np.zeros((len(users), length), np.float32)
    for row, u in enumerate(users):
        items = log.train_sequence(int(u))[-length:]
        if len(items):
            seq[row, -len(items):] = items
            mask[row, -len(items):] = 1.0
    return seq, mask


class ReferenceServer:
    """The reference's top-k: one encode, then scores over the catalog with
    each user's input items excluded."""

    def __init__(self, cell, log: logs.Log, seed: int, device):
        m = cell.model
        self.cell, self.log, self.device = cell, log, device
        graph = ref.Graph.from_edges(logs.interval_edges(log, m["graph_num"]),
                                     log.num_users, log.num_items, device)
        self.model = ref.SelfGNN(m, graph)
        self.p = make_weights(m, log.num_users, log.num_items, seed, device)
        with torch.no_grad():
            self.fu, self.fi, _, _ = self.model.encode(self.p)

    @torch.no_grad()
    def scores(self, users: np.ndarray) -> torch.Tensor:
        """[B, I] scores, the input items at -inf."""
        seq, mask = user_inputs(self.log, users,
                                self.cell.model["pos_length"])
        seq = torch.from_numpy(seq).to(self.device)
        mask = torch.from_numpy(mask).to(self.device)
        q = self.model.queries(self.p, self.fu, self.fi,
                               torch.from_numpy(users).to(self.device),
                               seq, mask)
        s = q @ self.fi.T
        # padded slots mark a column past the catalog, dropped after
        cols = torch.where(mask > 0, seq, torch.full_like(seq, s.shape[1]))
        seen = torch.zeros((s.shape[0], s.shape[1] + 1), dtype=torch.bool,
                           device=s.device)
        seen.scatter_(1, cols, True)
        return s.masked_fill(seen[:, :-1], float("-inf"))

    @torch.no_grad()
    def top_k(self, users: np.ndarray, k: int):
        s = self.scores(users)
        v, i = torch.topk(s, k, dim=1)
        return v.cpu().numpy(), i.cpu().numpy().astype(np.int32)


def judge_results(server: ReferenceServer, requests, picked) -> dict:
    """The worst of the numbers over the picked (request index, scores,
    ids) results."""
    worst: Dict[str, float] = {}
    for r, scores, ids in picked:
        want = server.scores(requests[r])
        got = oracle.serve_numbers(torch.from_numpy(scores).to(want.device),
                                   torch.from_numpy(ids).to(want.device),
                                   want)
        for k, v in got.items():
            worst[k] = max(worst.get(k, 0.0), v)
        del want
    return worst


def check(prog: Program, device: torch.device) -> Dict[str, float]:
    cell, log, seed = prog.cell, prog.log, prog.seed
    picked = [prog.results[i] for i in sample(len(prog.results), seed)]
    requests = prog.requests
    prog.release()
    ref.set_tf32(False)
    server = ReferenceServer(cell, log, seed, device)
    return judge_results(server, requests, picked)
