"""Per-file seconds of a pytest run, from its junit xml: the table behind
the repository root's ``conftest.py`` (which orders test files heaviest
first).

    python scripts/tier1_file_seconds.py /tmp/_t1.xml

prints one ``"tests/test_x.py": seconds,`` line per file, heaviest first
(each file's test cases summed, setup and teardown included, so a module
fixture's time counts), then the total and the count of files. Takes the
xml of the tier-1 command in ROADMAP.md, run to its end.
"""

from __future__ import annotations

import sys
import xml.etree.ElementTree as ET
from collections import defaultdict


def file_seconds(xml_path):
    """``{test file: summed seconds}`` of a junit xml."""
    out = defaultdict(float)
    for case in ET.parse(xml_path).getroot().iter("testcase"):
        parts = case.get("classname", "").split(".")
        path = "/".join(parts[:2]) + ".py" if len(parts) >= 2 else case.get("file", "?")
        out[path] += float(case.get("time", 0.0))
    return dict(out)


def main(argv):
    if len(argv) != 2:
        print(__doc__, file=sys.stderr)
        return 2
    secs = file_seconds(argv[1])
    for path, sec in sorted(secs.items(), key=lambda kv: -kv[1]):
        print(f'    "{path}": {sec:.1f},')
    print(f"# total {sum(secs.values()):.1f} s over {len(secs)} files")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
