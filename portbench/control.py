"""The readings the check's limits are set from, at a cell's own size:

    python3 portbench/control.py --workload <cell> --program-seeds 1 2 ...
        --control-seeds 101 102 103

For each program seed: the cell's inputs, one warm-up call and one call of
the program, judged as a run judges its window. For each control seed: the
reference put in the program's place in the next precision below the
configuration's (``control_fit`` of ``reference/<algorithm>.py``), judged
alike; the control has to fail one of the cell's numbers. Prints one JSON
line a seed, then the largest program reading and the smallest control
reading of each number.
"""

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def readings(workload, program_seeds, control_seeds, device="cuda",
             spec=None, config=None, out=print):
    """(program numbers, control numbers): one dict of numbers a seed."""
    import torch

    from portbench.harness.bench import Cell

    cell = Cell(workload, device, spec, config)
    sides = {"program": [], "control": []}
    for side, seeds in (("program", program_seeds),
                        ("control", control_seeds)):
        for seed in seeds:
            inputs, params = cell.inputs(seed), cell.params(seed)
            if side == "program":
                call = cell.caller(inputs, params)
                call()
                answers = [call()]
            else:
                answers = [cell.reference.control_fit(inputs, params)]

                def call(**changed):
                    return cell.reference.control_fit(
                        inputs, {**params, **changed})
            numbers, _ = cell.judge(inputs, params, answers, call)
            sides[side].append(numbers)
            out(json.dumps({"side": side, "seed": seed, **numbers}))
            del inputs, answers, call
            if device == "cuda":
                torch.cuda.empty_cache()
    return sides["program"], sides["control"]


def main(argv):
    parser = argparse.ArgumentParser(prog="portbench/control.py")
    parser.add_argument("--workload", required=True)
    parser.add_argument("--program-seeds", type=int, nargs="*", default=())
    parser.add_argument("--control-seeds", type=int, nargs="*", default=())
    args = parser.parse_args(argv)
    program, control = readings(args.workload, args.program_seeds,
                                args.control_seeds)
    for name, value in (program or control)[0].items():
        if not isinstance(value, float):
            continue
        print(json.dumps({
            "number": name,
            "program_max": max((p[name] for p in program), default=None),
            "control_min": min((c[name] for c in control), default=None)}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
