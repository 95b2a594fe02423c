"""Closed-loop load client of the serve cell, run in a process of its own
(it imports neither PyTorch nor the measured program):

    python3 perfbench/drivers/serve_client.py JOB.json

Each of ``clients`` threads keeps one HTTP/1.1 connection and sends one
``GET /tts?text=`` at a time, its next sentence as soon as the answer has
arrived.  Sentence ``j`` of client ``c`` has the phoneme count
``lengths[(c + clients·j) % len(lengths)]`` (the lengths are the mix's
quantiles in a seeded order) and words from a seeded generator.  The
clients warm for ``warm_s`` seconds, then the window of ``seconds`` runs;
no request starts after it, and those in flight finish.  The answers of
``keep_clients`` seeded clients are kept by reservoir sampling (one
each), and the longest answered in the window too, for the judgement.

Writes ``out_dir/result.json``: the window's wall-clock bounds, one row a
request (client, index, phonemes, send and done times, status, seconds
of audio, text) and the kept answers' texts and files.
"""

import http.client
import json
import os
import sys
import threading
import time
import urllib.parse

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(os.path.dirname(HERE)))

import numpy as np  # noqa: E402

from perfbench.yardstick.traffic import TextMaker  # noqa: E402


def audio_seconds(body: bytes, sampling_rate: int) -> float:
    if len(body) < 44 or body[:4] != b"RIFF":
        return 0.0
    return int.from_bytes(body[40:44], "little") / 2 / sampling_rate


def main(job_path: str):
    with open(job_path) as fh:
        job = json.load(fh)
    maker = TextMaker(job["lexicon"], job["pause_every"])
    lengths, n_clients = job["lengths"], job["clients"]
    keep = set(job["keep_clients"])
    t_w0 = time.time() + job["warm_s"]
    t_w1 = t_w0 + job["seconds"]
    rows, kept, longest = [], {}, {}
    lock = threading.Lock()

    def client(c: int):
        rng = np.random.default_rng([job["seed"], 2, c])
        pick = np.random.default_rng([job["seed"], 3, c])
        conn = http.client.HTTPConnection("127.0.0.1", job["port"],
                                          timeout=job["timeout_s"])
        seen, j = 0, 0
        while time.time() < t_w1:
            n = lengths[(c + n_clients * j) % len(lengths)]
            text = maker.text(rng, n)
            t0 = time.time()
            try:
                conn.request("GET", "/tts?text=" + urllib.parse.quote(text))
                resp = conn.getresponse()
                body, status = resp.read(), resp.status
            except (OSError, http.client.HTTPException):
                body, status = b"", 0
                conn.close()
                conn = http.client.HTTPConnection(
                    "127.0.0.1", job["port"], timeout=job["timeout_s"])
            t1 = time.time()
            secs = audio_seconds(body, job["sampling_rate"]) if (
                status == 200) else 0.0
            in_window = t_w0 <= t1 <= t_w1
            with lock:
                rows.append([c, j, n, t0, t1, status, secs, text])
                if in_window and status == 200:
                    item = {"text": text, "t0": t0, "t1": t1, "body": body,
                            "client": c, "index": j, "phonemes": n}
                    if c in keep:
                        seen += 1
                        if pick.integers(seen) == 0:
                            kept[c] = item
                    if n > longest.get("phonemes", -1):
                        longest.update(item)
            j += 1
        conn.close()

    threads = [threading.Thread(target=client, args=(c,), daemon=True)
               for c in range(n_clients)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    items = list(kept.values())
    if longest and not any(i["t0"] == longest["t0"]
                           and i["client"] == longest["client"]
                           for i in items):
        items.append(longest)
    out = []
    for k, it in enumerate(items):
        path = os.path.join(job["out_dir"], f"answer_{k}.wav")
        with open(path, "wb") as fh:
            fh.write(it.pop("body"))
        out.append(dict(it, file=path))
    with open(os.path.join(job["out_dir"], "result.json"), "w") as fh:
        json.dump({"t_w0": t_w0, "t_w1": t_w1, "rows": rows, "kept": out},
                  fh)


if __name__ == "__main__":
    main(sys.argv[1])
