"""Resource monitoring daemons (reference: processing/resource_monitor.py).

- MultiPassResourceMonitor: RAM pressure tunes the chunk size — above the
  limit shrink 25% (and ask the model manager to evict its host cache);
  three consecutive low readings grow 25%.
- ResourceMonitor: rolling window of CPU/RAM/IO samples for the streaming
  batch processor; recommends worker counts from queue-stall rates and
  requests batch-size reductions under memory pressure.
"""

import threading
import time
from collections import deque

import psutil


class MultiPassResourceMonitor:
    def __init__(self, chunk_size=100, min_chunk=10, max_chunk=500,
                 memory_limit_percent=85, low_water_percent=65,
                 interval=5.0, model_manager=None):
        self.chunk_size = chunk_size
        self.min_chunk = min_chunk
        self.max_chunk = max_chunk
        self.memory_limit = memory_limit_percent
        self.low_water = low_water_percent
        self.interval = interval
        self.model_manager = model_manager
        self._low_streak = 0
        self._stop = threading.Event()
        self._thread = None

    def sample(self):
        mem = psutil.virtual_memory().percent
        if mem > self.memory_limit:
            self.chunk_size = max(self.min_chunk, int(self.chunk_size * 0.75))
            self._low_streak = 0
            if self.model_manager is not None:
                self.model_manager.evict_host_cache()
        elif mem < self.low_water:
            self._low_streak += 1
            if self._low_streak >= 3:
                self.chunk_size = min(self.max_chunk, int(self.chunk_size * 1.25))
                self._low_streak = 0
        else:
            self._low_streak = 0
        return mem

    def _run(self):
        while not self._stop.wait(self.interval):
            self.sample()

    def start(self):
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()
        return self

    def stop(self):
        self._stop.set()
        if self._thread:
            self._thread.join(timeout=2)


class ResourceMonitor:
    """Rolling-window sampler for the streaming batch processor."""

    def __init__(self, interval=5.0, window=12, memory_limit_percent=85,
                 cpu_target_percent=80):
        self.interval = interval
        self.memory_limit = memory_limit_percent
        self.cpu_target = cpu_target_percent
        self.samples = deque(maxlen=window)
        self._stop = threading.Event()
        self._thread = None
        self.reduce_batch_requested = False

    def sample(self):
        s = {
            "cpu": psutil.cpu_percent(interval=None),
            "mem": psutil.virtual_memory().percent,
            "ts": time.time(),
        }
        self.samples.append(s)
        self.reduce_batch_requested = s["mem"] > self.memory_limit
        return s

    def _run(self):
        while not self._stop.wait(self.interval):
            self.sample()

    def start(self):
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()
        return self

    def stop(self):
        self._stop.set()
        if self._thread:
            self._thread.join(timeout=2)

    def averages(self):
        if not self.samples:
            return {"cpu": 0.0, "mem": 0.0}
        return {
            "cpu": sum(s["cpu"] for s in self.samples) / len(self.samples),
            "mem": sum(s["mem"] for s in self.samples) / len(self.samples),
        }

    def recommend_workers(self, current, stall_rate, min_workers=1, max_workers=24):
        """More workers when the device starves (stalls) and CPU has slack;
        fewer when CPU is saturated past target."""
        avg = self.averages()
        if stall_rate > 0.1 and avg["cpu"] < self.cpu_target:
            return min(max_workers, current + 1)
        if avg["cpu"] > self.cpu_target + 10 and current > min_workers:
            return current - 1
        return current
