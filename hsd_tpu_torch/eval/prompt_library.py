"""GSM8K few-shot prompt library generator (SURVEY §2.2 G5; the port's own
copy of `hsd_tpu/eval/prompt_library.py`, numpy only).

The reference ships 27 `lib_prompt/*.txt` ablation prompts (difficulty
tiers, formatting transforms, step-count mixes, question-length buckets)
plus two index `.npy` files, and its harness defaults to
`prompt_hardest.txt` (eval_speculative_decoding_llm.py:378). Those files
are third-party content we must not copy, so this module COMPOSES an
original library with the same structure: exemplar problems are generated
from parameterized templates whose arithmetic is computed (and asserted)
in code, then rendered through the same format transforms the reference's
variants exercise.

Every file name matches the reference's so ablation scripts keyed on file
names port directly. Regenerate with:
    python -m hsd_tpu_torch.eval.prompt_library [outdir]
`prompt_original.txt` is hand-written, as in the reference package, and
kept beside the generated files.
"""
from __future__ import annotations

import os
import sys
from dataclasses import dataclass
from typing import Callable, Dict, List

import numpy as np


@dataclass
class Exemplar:
    question: str
    steps: List[str]          # CoT body lines (without the answer line)
    answer: int

    @property
    def n_steps(self) -> int:
        return len(self.steps)

    @property
    def q_words(self) -> int:
        return len(self.question.split())


# ---------------------------------------------------------------------------
# Templates: each returns an Exemplar with computed, asserted arithmetic.
# ---------------------------------------------------------------------------

def t_factory(name, uA, hA, uB, hB, defect_pct, days_full, split_defect,
              extra_parts):
    """Factory order: 8 steps, 9 with the defect computation split."""
    a = uA * hA
    b = uB * hB
    t = a + b
    assert t * defect_pct % 100 == 0
    rej = t * defect_pct // 100
    g = t - rej
    made = days_full * g
    r = extra_parts
    assert 0 < r < g
    N = made + r
    steps = [
        f"Machine A makes {uA} parts per hour, so in its {hA}-hour shift it "
        f"makes {uA} x {hA} = {a} parts a day.",
        f"Machine B makes {uB} parts per hour, so in its {hB}-hour shift it "
        f"makes {uB} x {hB} = {b} parts a day.",
        f"Together the machines make {a} + {b} = {t} parts a day.",
    ]
    if split_defect:
        steps += [
            f"Out of every 100 parts, {defect_pct} fail inspection, so "
            f"{t} x {defect_pct} / 100 = {rej} parts are rejected each day.",
            f"That leaves {t} - {rej} = {g} good parts a day.",
        ]
    else:
        steps += [
            f"Since {defect_pct} out of every 100 parts fail inspection, a "
            f"day yields {t} x {100 - defect_pct} / 100 = {g} good parts.",
        ]
    steps += [
        f"After {days_full} full days the factory has "
        f"{days_full} x {g} = {made} good parts.",
        f"The order needs {N} parts, so {N} - {made} = {r} parts are still "
        f"missing.",
        f"{r} is less than a full day's {g} good parts, so one more day is "
        f"enough.",
        f"In total the factory needs {days_full} + 1 = {days_full + 1} days.",
    ]
    q = (f"A factory takes an order for {N} machine parts. Machine A makes "
         f"{uA} parts per hour and runs {hA} hours a day, while machine B "
         f"makes {uB} parts per hour and runs {hB} hours a day. Quality "
         f"control rejects {defect_pct} out of every 100 parts produced. "
         f"How many days does the factory need to finish the order?")
    return Exemplar(q, steps, days_full + 1)


def t_courier(name, p1, w1, p2, w2, cap, drive_min, load_min, day_hours,
              ceil_day):
    """Courier trips: 8 steps exact-divide, 9 with a partial last day."""
    W1 = p1 * w1
    W2 = p2 * w2
    W = W1 + W2
    assert W % cap == 0
    T = W // cap
    m = drive_min + load_min
    M = T * m
    assert M % 60 == 0
    H = M // 60
    steps = [
        f"The {p1} small packages weigh {w1} kg each, so together they "
        f"weigh {p1} x {w1} = {W1} kg.",
        f"The {p2} large packages weigh {w2} kg each, so together they "
        f"weigh {p2} x {w2} = {W2} kg.",
        f"All packages together weigh {W1} + {W2} = {W} kg.",
        f"Each trip carries at most {cap} kg, so the courier needs "
        f"{W} / {cap} = {T} trips.",
        f"One trip takes {drive_min} minutes of driving plus {load_min} "
        f"minutes of loading, {drive_min} + {load_min} = {m} minutes.",
        f"{T} trips take {T} x {m} = {M} minutes.",
        f"That is {M} / 60 = {H} hours of work.",
    ]
    if ceil_day:
        f_days = H // day_hours
        rem = H - f_days * day_hours
        assert 0 < rem
        steps += [
            f"Working {day_hours} hours a day, {f_days} full days cover "
            f"{f_days} x {day_hours} = {f_days * day_hours} hours.",
            f"The remaining {rem} hours fit in one more day, so the courier "
            f"needs {f_days} + 1 = {f_days + 1} days.",
        ]
        ans = f_days + 1
    else:
        assert H % day_hours == 0
        ans = H // day_hours
        steps += [
            f"The courier works {day_hours} hours a day, so the job takes "
            f"{H} / {day_hours} = {ans} days.",
        ]
    q = (f"A courier must deliver {p1} small packages weighing {w1} kg each "
         f"and {p2} large packages weighing {w2} kg each. The van carries at "
         f"most {cap} kg per trip, each trip takes {drive_min} minutes of "
         f"driving and {load_min} minutes of loading, and the courier works "
         f"{day_hours} hours a day. How many days does the delivery take?")
    return Exemplar(q, steps, ans)


def t_quiz(name, e_pts, e_n, m_pts, m_n, h_pts, h_n, opp_factor_e,
           opp_div_mh):
    """Quiz contest points: 8 steps (two-team totals)."""
    e = e_pts * e_n
    m = m_pts * m_n
    h = h_pts * h_n
    ours = e + m + h
    oe = e * opp_factor_e
    assert m % opp_div_mh == 0 and h % opp_div_mh == 0
    om = m // opp_div_mh
    oh = h // opp_div_mh
    theirs = oe + om + oh
    total = ours + theirs
    steps = [
        f"Our team answers {e_n} easy questions worth {e_pts} points each, "
        f"{e_n} x {e_pts} = {e} points.",
        f"It answers {m_n} medium questions worth {m_pts} points each, "
        f"{m_n} x {m_pts} = {m} points.",
        f"It answers {h_n} hard questions worth {h_pts} points each, "
        f"{h_n} x {h_pts} = {h} points.",
        f"Our team scores {e} + {m} + {h} = {ours} points in total.",
        f"The other team scores {opp_factor_e} times our easy points, "
        f"{e} x {opp_factor_e} = {oe} points.",
        f"They score {m} / {opp_div_mh} = {om} points on medium questions.",
        f"They score {h} / {opp_div_mh} = {oh} points on hard questions.",
        f"Both teams together score {ours} + {oe} + {om} + {oh} = {total} "
        f"points.",
    ]
    q = (f"In a quiz contest our team answers {e_n} easy questions worth "
         f"{e_pts} points each, {m_n} medium questions worth {m_pts} points "
         f"each and {h_n} hard questions worth {h_pts} points each. The "
         f"other team scores {opp_factor_e} times our easy points but only "
         f"1/{opp_div_mh} of our medium and hard points. How many points do "
         f"the two teams score together?")
    return Exemplar(q, steps, total)


def t_shop(name, n1, p1, n2, p2, discount, paid):
    """Shopping with discount: 5 steps (mid tier)."""
    c1 = n1 * p1
    c2 = n2 * p2
    tot = c1 + c2
    after = tot - discount
    change = paid - after
    assert change > 0
    steps = [
        f"The {n1} notebooks cost {n1} x {p1} = ${c1}.",
        f"The {n2} pens cost {n2} x {p2} = ${c2}.",
        f"Together that is {c1} + {c2} = ${tot}.",
        f"With the ${discount} coupon the bill is {tot} - {discount} = "
        f"${after}.",
        f"Paying with ${paid} leaves {paid} - {after} = ${change} change.",
    ]
    q = (f"Lena buys {n1} notebooks for ${p1} each and {n2} pens for ${p2} "
         f"each. She uses a ${discount} coupon and pays with a ${paid} "
         f"bill. How much change does she get?")
    return Exemplar(q, steps, change)


def t_trip(name, s1, t1, s2, t2):
    """Road trip distance: 4 steps (mid tier)."""
    d1 = s1 * t1
    d2 = s2 * t2
    tot = d1 + d2
    steps = [
        f"In the first part he drives {s1} km/h for {t1} hours, covering "
        f"{s1} x {t1} = {d1} km.",
        f"In the second part he drives {s2} km/h for {t2} hours, covering "
        f"{s2} x {t2} = {d2} km.",
        f"The whole trip is {d1} + {d2} = {tot} km.",
        f"So he drives {tot} km in total.",
    ]
    q = (f"Omar drives {t1} hours at {s1} km/h and then {t2} hours at "
         f"{s2} km/h. How far does he drive in total?")
    return Exemplar(q, steps, tot)


def t_eggs(name, hens, eggs_each, eaten):
    """Easy: 3 steps."""
    tot = hens * eggs_each
    left = tot - eaten
    steps = [
        f"The {hens} hens lay {hens} x {eggs_each} = {tot} eggs.",
        f"After {eaten} eggs are used for breakfast, {tot} - {eaten} = "
        f"{left} are left.",
        f"So {left} eggs remain.",
    ]
    q = (f"A farm's {hens} hens each lay {eggs_each} eggs. {eaten} eggs are "
         f"used for breakfast. How many eggs are left?")
    return Exemplar(q, steps, left)


def t_garden(name, rows, per_row, fail_each_row, price):
    """Mid: 5 steps."""
    tot = rows * per_row
    fail = rows * fail_each_row
    grow = tot - fail
    money = grow * price
    steps = [
        f"{rows} rows with {per_row} seedlings each hold {rows} x "
        f"{per_row} = {tot} seedlings.",
        f"In every row {fail_each_row} seedlings die, {rows} x "
        f"{fail_each_row} = {fail} in total.",
        f"So {tot} - {fail} = {grow} plants grow to harvest.",
        f"Each plant sells for ${price}, giving {grow} x {price} = "
        f"${money}.",
        f"The garden earns ${money}.",
    ]
    q = (f"A gardener plants {rows} rows of {per_row} tomato seedlings. In "
         f"each row {fail_each_row} seedlings die. Every surviving plant "
         f"sells for ${price}. How much does the garden earn?")
    return Exemplar(q, steps, money)


def t_library(name, shelves, per_shelf, borrowed, returned, donate_box):
    """Mid-hard: 6 steps, long question."""
    tot = shelves * per_shelf
    after_b = tot - borrowed
    after_r = after_b + returned
    after_d = after_r + donate_box
    steps = [
        f"The {shelves} shelves hold {shelves} x {per_shelf} = {tot} books.",
        f"After {borrowed} books are borrowed there are {tot} - {borrowed} "
        f"= {after_b} books.",
        f"When {returned} books come back the count is {after_b} + "
        f"{returned} = {after_r}.",
        f"A donation adds {donate_box} more books.",
        f"That makes {after_r} + {donate_box} = {after_d} books.",
        f"The library now has {after_d} books.",
    ]
    q = (f"A small library has {shelves} shelves with {per_shelf} books on "
         f"each shelf. During the week {borrowed} books are borrowed and "
         f"{returned} of them are returned, and on Friday a donation box "
         f"with {donate_box} books arrives. Counting all shelves together, "
         f"how many books does the library have at the end of the week?")
    return Exemplar(q, steps, after_d)


# ---------------------------------------------------------------------------
# The exemplar pool (all arithmetic asserted at import time)
# ---------------------------------------------------------------------------

def build_pool() -> Dict[str, Exemplar]:
    pool = {
        # hard, 9 steps
        "factory9a": t_factory("a", 30, 8, 20, 6, 10, 4, True, 100),
        "factory9b": t_factory("b", 25, 8, 25, 8, 5, 5, True, 200),
        "factory9c": t_factory("f", 35, 8, 20, 6, 15, 3, True, 140),
        "factory9d": t_factory("g", 45, 8, 40, 9, 20, 6, True, 176),
        "courier9a": t_courier("a", 30, 2, 20, 7, 50, 35, 25, 3, True),
        "courier9b": t_courier("b", 40, 3, 30, 6, 60, 40, 20, 4, True),
        "courier9c": t_courier("e", 60, 2, 40, 6, 45, 28, 17, 4, True),
        "courier9d": t_courier("f", 36, 5, 60, 4, 70, 50, 10, 4, True),
        # hard, 8 steps
        "factory8a": t_factory("c", 40, 6, 30, 4, 10, 5, False, 150),
        "factory8b": t_factory("d", 50, 7, 25, 10, 20, 3, False, 300),
        "factory8c": t_factory("e", 20, 9, 30, 6, 25, 6, False, 90),
        "courier8a": t_courier("c", 25, 4, 25, 8, 60, 30, 30, 5, False),
        "courier8b": t_courier("d", 50, 2, 20, 10, 30, 18, 12, 5, False),
        "quiz8a": t_quiz("a", 2, 15, 4, 10, 6, 5, 3, 2),
        "quiz8b": t_quiz("b", 1, 20, 3, 12, 5, 8, 2, 4),
        "quiz8c": t_quiz("c", 2, 25, 5, 8, 10, 4, 2, 2),
        # mid (4-6 steps)
        "shop1": t_shop("a", 3, 4, 5, 2, 3, 20),
        "shop2": t_shop("b", 4, 5, 6, 3, 8, 50),
        "trip1": t_trip("a", 60, 3, 80, 2),
        "trip2": t_trip("b", 90, 2, 70, 4),
        "garden1": t_garden("a", 6, 15, 2, 3),
        "garden2": t_garden("b", 8, 12, 3, 4),
        "library1": t_library("a", 9, 24, 37, 18, 45),
        "library2": t_library("b", 12, 30, 85, 40, 66),
        # easy (3 steps)
        "eggs1": t_eggs("a", 12, 6, 20),
        "eggs2": t_eggs("b", 9, 8, 30),
        "eggs3": t_eggs("c", 15, 4, 25),
        "eggs4": t_eggs("d", 7, 10, 16),
    }
    for name, ex in pool.items():
        assert ex.answer > 0, name
    return pool


# ---------------------------------------------------------------------------
# Rendering + format transforms (the reference's ablation axes)
# ---------------------------------------------------------------------------

def render(ex: Exemplar, style: str = "original") -> str:
    """One exemplar in the given format style."""
    steps = list(ex.steps)
    if style == "explicit":
        steps = [f"Step {i + 1}: {s}" for i, s in enumerate(steps)]
    elif style == "exclamation":
        steps = [s[:-1] + "!" if s.endswith(".") else s + "!" for s in steps]
    elif style == "semicolon":
        body = "; ".join(s[:-1] if s.endswith(".") else s for s in steps)
        return (f"Question: {ex.question}\nLet's think step by step\n"
                f"{body}.\nThe answer is {ex.answer}\n")
    elif style == "no_break":
        body = " ".join(steps)
        return (f"Question: {ex.question}\nLet's think step by step\n"
                f"{body}\nThe answer is {ex.answer}\n")
    elif style == "ao":   # answer-only: no chain of thought
        return f"Question: {ex.question}\nThe answer is {ex.answer}\n"
    body = "\n".join(steps)
    return (f"Question: {ex.question}\nLet's think step by step\n"
            f"{body}\nThe answer is {ex.answer}\n")


def render_file(exemplars: List[Exemplar], style: str = "original") -> str:
    return "\n".join(render(ex, style) for ex in exemplars)


def build_library(outdir: str, seed: int = 0,
                  train_size: int = 7473) -> List[str]:
    """Write the full prompt library + index npys. Returns file names."""
    os.makedirs(outdir, exist_ok=True)
    pool = build_pool()
    g = lambda *names: [pool[n] for n in names]

    hard9 = g("factory9a", "factory9b", "factory9c", "factory9d",
              "courier9a", "courier9b", "courier9c", "courier9d")
    hard8 = g("factory8a", "factory8b", "factory8c", "courier8a",
              "courier8b", "quiz8a", "quiz8b", "quiz8c")
    mid = g("shop1", "shop2", "trip1", "trip2", "garden1", "garden2",
            "library1", "library2")
    easy = g("eggs1", "eggs2", "eggs3", "eggs4")

    # the harness default ("prompt_complex" in the reference's naming,
    # eval_speculative_decoding_llm.py:373-378): 8 hardest exemplars
    hardest = hard9
    hard = hard8
    base8 = mid  # formatting ablations run on the mid-tier 8-shot set
    simple4 = easy  # 4-shot simple set

    files: Dict[str, str] = {
        "prompt_hardest.txt": render_file(hardest),
        "prompt_hard.txt": render_file(hard),
        "prompt_mid.txt": render_file(mid),
        "prompt_easy.txt": render_file(easy + mid[:4]),
        # formatting ablations of the same 8-shot base
        "prompt_explicit.txt": render_file(base8, "explicit"),
        "prompt_exclamation.txt": render_file(base8, "exclamation"),
        "prompt_semicolon.txt": render_file(base8, "semicolon"),
        "prompt_no_break.txt": render_file(base8, "no_break"),
        # 4-shot simple variants
        "prompt_simple_4_cases.txt": render_file(simple4),
        "prompt_simple_4_cases_ao.txt": render_file(simple4, "ao"),
        "prompt_simple_explicit.txt": render_file(simple4, "explicit"),
        "prompt_simple_exclamation.txt": render_file(simple4, "exclamation"),
        "prompt_simple_semicolon.txt": render_file(simple4, "semicolon"),
        "prompt_simple_no_break.txt": render_file(simple4, "no_break"),
        # step-count mixes (file names state the composition)
        "prompt_6_9step.txt": render_file(hard9[:6]),
        "prompt_7x8step.txt": render_file(hard8[:7]),
        "prompt_8x8step.txt": render_file(hard8[:8]),
        "prompt_9x8step.txt": render_file(hard8 + hard8[:1]),
        "prompt_4_9step_4_8step.txt": render_file(hard9[:4] + hard8[:4]),
        "prompt_8_9step_2_8step.txt": render_file(hard9 + hard8[:2]),
    }

    # question-length buckets
    all_ex = sorted(pool.values(), key=lambda e: e.q_words)
    files["prompt_short_questions.txt"] = render_file(all_ex[:8])
    n = len(all_ex)
    files["prompt_mid_length_questions.txt"] = render_file(
        all_ex[n // 2 - 4:n // 2 + 4])
    files["prompt_long_questions.txt"] = render_file(all_ex[-8:])
    files["prompt_longest.txt"] = render_file(
        sorted(pool.values(), key=lambda e: len(render(e)))[-8:])
    # many short sentences per solution = the hard tier (long steps split
    # into short factual sentences)
    files["prompt_long_step_short_sent.txt"] = render_file(hard9 + hard8[:4])

    rng = np.random.default_rng(seed)
    sel = list(pool.values())
    files["prompt_random.txt"] = render_file(
        [sel[i] for i in rng.permutation(len(sel))[:8]])

    for name, text in files.items():
        with open(os.path.join(outdir, name), "w") as f:
            f.write(text)

    # index files: validation split indices into the GSM8K TRAIN set
    # (ref eval_speculative_decoding_llm.py:106) and an 8-question
    # random pick
    val = rng.choice(train_size, size=200, replace=False).astype(np.int64)
    rnd = rng.choice(train_size, size=8, replace=False).astype(np.int64)
    np.save(os.path.join(outdir, "validation_index.npy"), val)
    np.save(os.path.join(outdir, "random_index.npy"), rnd)
    return sorted(files) + ["validation_index.npy", "random_index.npy"]


if __name__ == "__main__":
    out = sys.argv[1] if len(sys.argv) > 1 else os.path.join(
        os.path.dirname(__file__), "lib_prompt")
    names = build_library(out)
    print(f"wrote {len(names)} files to {out}")
