#!/usr/bin/env python3
"""Run a command and time the phases of its output: each line is printed
with the seconds since the start in front, and one `phase_seconds` JSON
line ends the output. A phase ends at a line that opens with a
`<name>_timings ` record or with `ptxas_flash_wgmma` (chip_smoke.py's
default run prints one as it finishes each phase); its seconds are those
since the end of the phase before, keyed by that name, beside the total.
So two trees' default runs can be compared phase by phase:

    python3 scripts/phase_seconds.py python3 chip_smoke.py

Exits with the command's exit code."""

from __future__ import annotations

import json
import re
import subprocess
import sys
import time

MARK = re.compile(r"^(\w+_timings|ptxas_flash_wgmma)[ :]")


def main(argv: list[str]) -> int:
    start = time.perf_counter()
    last, phases = 0.0, {}
    with subprocess.Popen(argv, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                          text=True, bufsize=1) as proc:
        for line in proc.stdout:
            now = time.perf_counter() - start
            print(f"{now:9.2f} {line}", end="", flush=True)
            m = MARK.match(line)
            if m:
                phases[m.group(1)] = phases.get(m.group(1), 0.0) + now - last
                last = now
    total = time.perf_counter() - start
    phases["after_the_last"] = total - last
    print("phase_seconds " + json.dumps({"rc": proc.returncode, "total_s": total,
                                          "phases_s": phases}), flush=True)
    return proc.returncode


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
