"""First-run CLI: recovery-phrase UX (``client/src/ui/cli.rs``).

Counterpart of ``backuwup_tpu/ui/cli.py``, copied so that the port
imports nothing of the JAX package.

Fresh setup prints the recovery phrase derived from the root secret
(``cli.rs:55-77``, which prints a BIP39 mnemonic — here both a 24-word
mnemonic from the embedded wordlist and the compact base32 form); the
restore path prompts for an existing phrase in either form and rebuilds
the identity deterministically (``cli.rs:26-51`` + ``identity.rs:46-69``).
"""

from __future__ import annotations

import sys
from typing import Callable, Optional

from ..crypto import parse_recovery, secret_to_phrase, secret_to_words

BANNER = """\
Welcome to backuwup!

Your backups are encrypted with keys derived from a single root secret.
The RECOVERY PHRASE below is the only way to get your data back after a
disaster — write it down and keep it somewhere safe and offline.
"""


def print_recovery_phrase(root_secret: bytes, out=None) -> None:
    out = out or sys.stdout
    print(BANNER, file=out)
    words = secret_to_words(root_secret).split()
    for i in range(0, len(words), 6):
        print("    " + " ".join(f"{w:<8}" for w in words[i:i + 6]).rstrip(),
              file=out)
    print("\nor, equivalently, the compact form:\n", file=out)
    print("    " + secret_to_phrase(root_secret), file=out)
    print("\nEither form restores your identity. Anyone with this phrase "
          "can read your backups; never share it.", file=out)


def prompt_restore_phrase(input_fn: Optional[Callable[[str], str]] = None,
                          out=None) -> bytes:
    """Interactive phrase entry with validation loop (cli.rs:26-51);
    accepts the 24-word or the base32 form, returns the root secret."""
    input_fn = input_fn or input
    out = out or sys.stdout
    while True:
        phrase = input_fn("Enter your recovery phrase (words or code): ")
        try:
            return parse_recovery(phrase)
        except ValueError as e:
            print(f"That phrase is not valid ({e}); try again.", file=out)


def first_run_guide(input_fn: Optional[Callable[[str], str]] = None,
                    out=None) -> Optional[bytes]:
    """Fresh-start vs restore choice (cli.rs:10-23).

    Returns None to create a new identity, or the decoded root secret to
    restore an existing one.
    """
    input_fn = input_fn or input
    out = out or sys.stdout
    print("No existing identity found.", file=out)
    while True:
        ans = input_fn(
            "Start fresh (n) or restore from a recovery phrase (r)? [n/r] ")
        ans = ans.strip().lower()
        if ans in ("", "n", "new"):
            return None
        if ans in ("r", "restore"):
            return prompt_restore_phrase(input_fn, out)
        print("Please answer 'n' or 'r'.", file=out)
