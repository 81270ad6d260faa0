"""Structured JSONL experiment logger + offline visualizer: the port's copy
of ``yolact_tpu/utils/logger.py``.

Parity with the reference logger (``utils/logger.py``): one append-only
``<session_name>.log`` JSONL file per run, a session header entry with
config/env info, per-iteration loss/lr entries, per-epoch validation
entries.  ``LogVisualizer`` replays files for plotting/analysis with a
dotted-path query mini-language (plain attribute paths — no ``eval`` of
arbitrary code, unlike the reference's lambda strings).  With
``log_gpu_stats`` the session header lists the CUDA devices
(``utils/nvinfo.py:device_info``: name, total memory and NVML's power
limit) and every entry their ``torch.cuda.memory_allocated`` and
``max_memory_allocated`` (the JAX package logs its PJRT devices and HBM
use there).
"""

from __future__ import annotations

import json
import os
import platform
import sys
import time
from typing import Any, Callable, Dict, List, Optional, Union

from yolact_tpu_torch.utils import nvinfo


class Log:
    def __init__(self, log_name: str, log_dir: str = 'logs/',
                 session_data: Optional[dict] = None,
                 overwrite: bool = False, log_gpu_stats: bool = False,
                 log_time: bool = True):
        os.makedirs(log_dir, exist_ok=True)
        self.path = os.path.join(log_dir, log_name + '.log')
        if overwrite and os.path.exists(self.path):
            os.unlink(self.path)
        self.log_gpu_stats = log_gpu_stats
        self.log_time = log_time
        self.session_id = None
        self._log_session_header(session_data or {})

    def _write(self, entry: dict):
        with open(self.path, 'a') as f:
            f.write(json.dumps(entry) + '\n')

    def _log_session_header(self, session_data: dict):
        self.session_id = int(time.time())
        info = {
            'type': 'session', 'session': self.session_id,
            'data': session_data,
            'env': {
                'python': sys.version.split()[0],
                'platform': platform.platform(),
                'argv': sys.argv,
            },
        }
        if self.log_time:
            info['time'] = time.time()
        if self.log_gpu_stats:
            info['env']['accelerators'] = self._device_info()
        self._write(info)

    @staticmethod
    def _device_info():
        # once per session: NVML's card-wide view as well
        return [{k: v for k, v in d.items()
                 if k in ('platform', 'kind', 'id', 'physical_id',
                          'memory_total', 'power_limit_w')}
                for d in nvinfo.device_info()]

    @staticmethod
    def _memory_info():
        # every entry: this process's memory, no nvidia-smi call
        return [{k: v for k, v in d.items()
                 if k in ('id', 'memory_allocated', 'max_memory_allocated')}
                for d in nvinfo.device_info(nvml=False)]

    def log(self, type_: str, data: Optional[dict] = None, **kwargs):
        entry: Dict[str, Any] = {'type': type_, 'session': self.session_id}
        d = dict(data or {})
        d.update(kwargs)
        entry['data'] = d
        if self.log_time:
            entry['time'] = time.time()
        if self.log_gpu_stats:
            # live per-entry device memory like the reference's per-entry
            # nvinfo scrape (logger.py:113-117)
            entry['accelerators'] = self._memory_info()
        self._write(entry)


class LogEntry(dict):
    """dict with attribute access for query convenience."""
    def __getattr__(self, k):
        try:
            v = self[k]
        except KeyError:
            raise AttributeError(k)
        return LogEntry(v) if isinstance(v, dict) else v


class LogVisualizer:
    """Loads JSONL logs and evaluates dotted-path queries like
    'data.loss.T' or callables over entries (utils/logger.py:153-470,
    minus the eval()-based lambda strings)."""

    def __init__(self):
        self.logs: List[LogEntry] = []
        self.path = None

    def load(self, path: str):
        self.path = path
        self.logs = []
        with open(path) as f:
            for line in f:
                line = line.strip()
                if line:
                    self.logs.append(LogEntry(json.loads(line)))

    def _resolve(self, entry: LogEntry,
                 query: Union[str, Callable]) -> Any:
        if callable(query):
            return query(entry)
        cur: Any = entry
        for part in query.split('.'):
            if cur is None:
                return None
            if isinstance(cur, dict):
                cur = cur.get(part)
            else:
                cur = getattr(cur, part, None)
        return cur

    def query(self, q: Union[str, Callable],
              entry_type: Optional[str] = None) -> List[Any]:
        out = []
        for e in self.logs:
            if entry_type is not None and e.get('type') != entry_type:
                continue
            v = self._resolve(e, q)
            if v is not None:
                out.append(v)
        return out

    def query_joined(self, queries, entry_type: Optional[str] = None
                     ) -> List[tuple]:
        """Resolve several queries PER ENTRY, keeping only entries where
        all resolve — unlike independent query() calls, values stay
        paired when some entries lack a key (the reference extracts
        (x, y) from the same entry, logger.py:174-187)."""
        out = []
        for e in self.logs:
            if entry_type is not None and e.get('type') != entry_type:
                continue
            vals = tuple(self._resolve(e, q) for q in queries)
            if all(v is not None for v in vals):
                out.append(vals)
        return out

    def sessions(self) -> List[dict]:
        return [e for e in self.logs if e.get('type') == 'session']

    def elapsed_time(self) -> float:
        times = [e['time'] for e in self.logs if 'time' in e]
        return (max(times) - min(times)) if times else 0.0

    def bar(self, labels_query: Union[str, Callable],
            values_query: Union[str, Callable], entry_type: str = 'val',
            out_path: Optional[str] = None):
        """Bar chart over matching entries (logger.py bar command)."""
        pairs = self.query_joined((labels_query, values_query), entry_type)
        labels = [p[0] for p in pairs]
        values = [p[1] for p in pairs]
        import matplotlib
        matplotlib.use('Agg')
        import matplotlib.pyplot as plt
        plt.figure()
        n = len(values)
        plt.bar(range(n), values)
        plt.xticks(range(n), [str(l) for l in labels], rotation=45)
        if out_path:
            plt.savefig(out_path)
        return plt.gcf()

    def plot(self, x_query: str, y_query: str, entry_type: str = 'train',
             out_path: Optional[str] = None):
        pairs = self.query_joined((x_query, y_query), entry_type)
        xs = [p[0] for p in pairs]
        ys = [p[1] for p in pairs]
        import matplotlib
        matplotlib.use('Agg')
        import matplotlib.pyplot as plt
        plt.figure()
        plt.plot(xs, ys)
        plt.xlabel(x_query)
        plt.ylabel(y_query)
        if out_path:
            plt.savefig(out_path)
        return plt.gcf()
