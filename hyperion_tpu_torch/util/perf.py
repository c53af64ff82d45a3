"""Per-stage throughput accounting (ref: src/main/performance.f90:15-38 —
the reference prints photons, CPU seconds, and photons/sec per stats
interval; here each pipeline stage contributes one row and the table is
printed at the end of the run)."""

import sys
import time


class PerfTable:

    def __init__(self, enabled=True, stream=None):
        self.enabled = enabled
        self.stream = stream or sys.stdout
        self.rows = []
        self._t0 = None
        self._label = None

    def __getstate__(self):
        # a table crosses processes (a rank's run) without its stream
        return dict(self.__dict__, stream=None)

    def __setstate__(self, state):
        self.__dict__.update(state)
        self.stream = self.stream or sys.stdout

    def start(self, label):
        self._label = label
        self._t0 = time.time()

    def stop(self, photons=None, **extra):
        if self._t0 is None:
            return
        wall = time.time() - self._t0
        self.add(self._label, wall, photons=photons, **extra)
        self._t0 = None

    def add(self, label, wall, photons=None, **extra):
        self.rows.append(dict(label=label, wall=wall, photons=photons,
                              **extra))

    def report(self):
        if not (self.enabled and self.rows):
            return
        w = self.stream
        print("[perf] %-28s %12s %10s %12s %11s %6s" %
              ("stage", "photons", "seconds", "photons/s", "events/s",
               "occ"), file=w)
        print("[perf] " + "-" * 85, file=w)
        total_wall = 0.0
        total_phot = 0
        for r in self.rows:
            rate = ("%12.3g" % (r['photons'] / r['wall'])
                    if r.get('photons') and r['wall'] > 0 else "%12s" % "-")
            phot = ("%12d" % r['photons']) if r.get('photons') else \
                "%12s" % "-"
            ev = ("%11.3g" % (r['events'] / r['wall'])
                  if r.get('events') and r['wall'] > 0 else "%11s" % "-")
            # alive-lane occupancy: fraction of lane-steps doing real work
            occ = ("%5.1f%%" % (100.0 * r['events'] /
                                (r['steps'] * r['lanes']))
                   if r.get('events') and r.get('steps') and r.get('lanes')
                   else "%6s" % "-")
            print("[perf] %-28s %s %10.3f %s %s %s" %
                  (r['label'], phot, r['wall'], rate, ev, occ), file=w)
            total_wall += r['wall']
            total_phot += r.get('photons') or 0
        print("[perf] " + "-" * 85, file=w)
        rate = ("%12.3g" % (total_phot / total_wall)
                if total_phot and total_wall > 0 else "%12s" % "-")
        print("[perf] %-28s %12d %10.3f %s" %
              ("total", total_phot, total_wall, rate), file=w)
