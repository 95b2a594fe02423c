"""G2P quality measurement: phone error rate against reference entries.

The reference falls back to the neural ``g2p_en`` for OOV words
(reference: synthesize.py:33-35); our self-contained rule L2S
(text/g2p.py:rule_g2p) replaces it in this environment.  This module
quantifies how far it drifts: PER = edit_distance(pred, ref) / len(ref),
micro-averaged over an eval lexicon, with stress digits optionally
stripped (the rule G2P's stress placement is heuristic; segmental accuracy
is what decides intelligibility).
"""

import re
from typing import Dict, Iterable, List, Tuple


def strip_stress(phones: Iterable[str]) -> List[str]:
    return [re.sub(r"\d", "", p) for p in phones]


def edit_distance(a: List[str], b: List[str]) -> int:
    """Levenshtein distance over phone tokens."""
    m, n = len(a), len(b)
    prev = list(range(n + 1))
    for i in range(1, m + 1):
        cur = [i] + [0] * n
        ai = a[i - 1]
        for j in range(1, n + 1):
            cur[j] = min(prev[j] + 1, cur[j - 1] + 1,
                         prev[j - 1] + (ai != b[j - 1]))
        prev = cur
    return prev[n]


def load_eval_lexicon(path: str) -> Dict[str, List[str]]:
    lex = {}
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            parts = line.split()
            lex[parts[0]] = parts[1:]
    return lex


def phone_error_rate(g2p_fn, lexicon: Dict[str, List[str]],
                     ignore_stress: bool = True) -> Tuple[float, float, List]:
    """(micro PER, word accuracy, worst_cases) of ``g2p_fn`` vs the
    reference lexicon.  worst_cases: (word, ref, pred, dist) sorted by
    per-word error, for rule debugging."""
    total_dist = 0
    total_ref = 0
    exact = 0
    cases = []
    for word, ref in lexicon.items():
        pred = list(g2p_fn(word))
        if ignore_stress:
            ref_c, pred_c = strip_stress(ref), strip_stress(pred)
        else:
            ref_c, pred_c = list(ref), pred
        d = edit_distance(pred_c, ref_c)
        total_dist += d
        total_ref += len(ref_c)
        exact += d == 0
        cases.append((word, " ".join(ref_c), " ".join(pred_c), d))
    cases.sort(key=lambda c: -c[3])
    return (total_dist / max(total_ref, 1),
            exact / max(len(lexicon), 1), cases)
