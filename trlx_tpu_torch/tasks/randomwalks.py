"""Synthetic shortest-path task ("randomwalks").

The port's copy of ``examples/randomwalks/randomwalks.py`` (numpy only; the
same graph, walks and scores for the same seed): nodes are single
characters of a fixed alphabet (``builtin:chars`` tokenizer), the model
sees a start node as the prompt and must generate a path that reaches the
goal node in as few valid steps as possible.

Scoring: a walk earns ``shortest_len / taken_len`` (∈ (0, 1], 1 = optimal) if
it reaches the goal through valid edges, else 0. The mean over samples is the
"optimality" metric.
"""

from typing import Callable, Dict, List, Tuple

import numpy as np

GOAL = 0


def generate_random_walks(
    n_nodes: int = 21,
    max_length: int = 10,
    n_walks: int = 1000,
    p_edge: float = 0.1,
    seed: int = 1002,
) -> Tuple[Callable, Callable, List[str], List[str], List[float], str]:
    """Build the task.

    Returns ``(metric_fn, reward_fn, prompts, walks, walk_rewards, alphabet)``:
    ``prompts`` are start-node chars; ``walks`` are sampled random walks
    (offline dataset for ILQL/SFT) with their ``walk_rewards``.
    """
    rng = np.random.RandomState(seed)
    alphabet = "abcdefghijklmnopqrstuvwxyzABCDEFGHIJKLMNOPQRSTUVWXYZ"[:n_nodes]

    # random directed graph; regenerate until every node can reach the goal
    while True:
        adj = rng.rand(n_nodes, n_nodes) < p_edge
        np.fill_diagonal(adj, False)
        dist = _bfs_to_goal(adj, GOAL)
        if np.all(np.isfinite(dist[np.arange(n_nodes) != GOAL])):
            break

    node_char = {i: alphabet[i] for i in range(n_nodes)}
    char_node = {c: i for i, c in node_char.items()}

    def score_walk(sample: str) -> float:
        path = [char_node[c] for c in sample if c in char_node]
        if len(path) < 2:
            return 0.0
        taken = 0
        reached = path[0] == GOAL
        for u, v in zip(path, path[1:]):
            if not adj[u, v]:
                break
            taken += 1
            if v == GOAL:
                reached = True
                break
        if not reached or taken == 0:
            return 0.0
        return float(dist[path[0]]) / taken

    def metric_fn(samples: List[str], **kwargs) -> Dict[str, List[float]]:
        return {"optimality": [score_walk(s) for s in samples]}

    def reward_fn(samples: List[str], **kwargs) -> List[float]:
        return [score_walk(s) for s in samples]

    # offline dataset: random walks from random starts
    walks, walk_rewards = [], []
    starts = rng.randint(1, n_nodes, size=n_walks)
    for s in starts:
        node, path = s, [s]
        for _ in range(max_length - 1):
            succ = np.nonzero(adj[node])[0]
            if len(succ) == 0:
                break
            node = rng.choice(succ)
            path.append(node)
            if node == GOAL:
                break
        walk = "".join(node_char[n] for n in path)
        walks.append(walk)
        walk_rewards.append(score_walk(walk))

    prompts = [node_char[i] for i in range(1, n_nodes)]
    return metric_fn, reward_fn, prompts, walks, walk_rewards, alphabet


def _bfs_to_goal(adj: np.ndarray, goal: int) -> np.ndarray:
    """Shortest path length from every node TO the goal (BFS on edge-reverse)."""
    n = adj.shape[0]
    dist = np.full(n, np.inf)
    dist[goal] = 0
    frontier = [goal]
    while frontier:
        nxt = []
        for v in frontier:
            preds = np.nonzero(adj[:, v])[0]
            for u in preds:
                if not np.isfinite(dist[u]):
                    dist[u] = dist[v] + 1
                    nxt.append(u)
        frontier = nxt
    return dist
