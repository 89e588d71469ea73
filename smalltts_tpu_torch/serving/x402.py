"""x402 payment gating: duration-priced 402 challenges.

Behavioral parity with the reference server's payment layer
(reference: src/server/src/main.rs:26-89,158-165 and the e2e contract tests
src/server/tests/e2e.rs:87-315):

* price = ceil(duration_sec * 167) USDC smallest units (6 decimals) on Base —
  $0.01/min; duration defaults to 1.0 and clamps to >= 0.1 (main.rs:60-79).
  NB main.rs comments say $0.01/min while README claims $0.05/min — code wins
  (SURVEY.md "known quirks").
* unpaid requests -> 402 with a base64 `payment-required` header carrying the
  accepts list (scheme/network/payTo/maxAmountRequired), empty body;
* `/health` and discovery are never gated.

Verification modes: "disabled" (no gating), "trust" (any X-PAYMENT header
accepted — for offline deployments/tests), "facilitator" (POST the payment
to FACILITATOR_URL /verify; requires network egress), "local" (verify the
EIP-3009 TransferWithAuthorization signature in-process via serving/eth.py
— no facilitator, no egress; beyond the reference, whose server can only
delegate to a facilitator, src/server/src/main.rs:60-79).

Local mode checks: recovered EIP-712 signer == authorization.from, payTo,
value >= price, validity window, and nonce replay (bounded in-memory set).
It cannot broadcast the transfer on-chain; verified authorizations are
appended to `capture_path` (JSONL) so the operator can submit them later —
EIP-3009 authorizations are submittable by anyone at any time before
validBefore.

The PyTorch port's own copy of smalltts_tpu/serving/x402.py, with its imports
pointing at smalltts_tpu_torch; it behaves as that module does.
"""

from __future__ import annotations

import base64
import json
import math
import os
import threading
import time
from collections import OrderedDict
from dataclasses import dataclass, field
from typing import Optional, Tuple

RATE_PER_SECOND = 167  # ceil(10000 / 60): $0.01/min in USDC 6dp (main.rs:27)


def price_for_duration(duration_sec: float) -> int:
    """ceil(max(duration, 0.1) * 167) (main.rs:60-79)."""
    return math.ceil(max(duration_sec, 0.1) * RATE_PER_SECOND)


@dataclass
class X402Config:
    mode: str = "disabled"  # disabled | trust | facilitator | local
    pay_to: str = field(
        default_factory=lambda: os.environ.get(
            "PAYMENT_ADDRESS", "0xBAc675C310721717Cd4A37F6cbeA1F081b1C2a07"
        )
    )
    facilitator_url: str = field(
        default_factory=lambda: os.environ.get(
            "FACILITATOR_URL", "https://pay.openfacilitator.io"
        )
    )
    network: str = "eip155:8453"  # Base mainnet
    asset: str = "0x833589fCD6eDb6E08f4c7C32D4f71b54bdA02913"  # USDC on Base
    base_url: str = field(
        default_factory=lambda: os.environ.get("BASE_URL", "http://localhost:3000")
    )
    # EIP-712 domain of the payment asset (USDC-on-Base defaults); the
    # website uses the same defaults and honors `extra` overrides we emit
    usdc_name: str = "USD Coin"
    usdc_version: str = "2"
    # local mode: where verified authorizations are archived for later
    # on-chain submission (JSONL; None = don't archive)
    capture_path: Optional[str] = field(
        default_factory=lambda: os.environ.get("X402_CAPTURE_PATH") or None
    )


# EIP-3009 TransferWithAuthorization typed-data template (field order is
# hash-critical; pinned by tests against both this and the website client)
EIP3009_TYPES = {
    "EIP712Domain": [
        {"name": "name", "type": "string"},
        {"name": "version", "type": "string"},
        {"name": "chainId", "type": "uint256"},
        {"name": "verifyingContract", "type": "address"},
    ],
    "TransferWithAuthorization": [
        {"name": "from", "type": "address"},
        {"name": "to", "type": "address"},
        {"name": "value", "type": "uint256"},
        {"name": "validAfter", "type": "uint256"},
        {"name": "validBefore", "type": "uint256"},
        {"name": "nonce", "type": "bytes32"},
    ],
}

def _eip3009_typed_data(name: str, version: str, chain_id: int,
                        verifying_contract: str, authorization: dict) -> dict:
    """Single source of truth for the EIP-3009 typed-data envelope — the
    server's verifier (build_typed_data) and the Python client signer
    (sign_payment) MUST hash the identical structure, or signing silently
    desynchronizes from verification."""
    return {
        "types": EIP3009_TYPES,
        "primaryType": "TransferWithAuthorization",
        "domain": {
            "name": name,
            "version": version,
            "chainId": chain_id,
            "verifyingContract": verifying_contract,
        },
        "message": authorization,
    }


_NONCE_CAP = 65536  # bounded replay set: ~2 MB worst case, FIFO eviction


class X402Gate:
    def __init__(self, cfg: X402Config = None) -> None:
        self.cfg = cfg or X402Config()
        self._seen_nonces: "OrderedDict[bytes, None]" = OrderedDict()
        # nonces reserved by an in-flight request: check() reserves, settle()
        # burns, release() frees on failure. Without the reservation, ONE
        # signed payment authorized unbounded CONCURRENT synthesis — all
        # copies passed the side-effect-free check, did the device work, and
        # only the first settle succeeded (paid-once compute amplification).
        # Sequential retry-after-failure still works: the
        # server releases the reservation on every non-success path.
        self._pending_nonces: set = set()
        self._nonce_lock = threading.Lock()

    def payment_required_header(self, duration_sec: float, resource: str) -> str:
        amount = price_for_duration(duration_sec)
        payload = {
            "x402Version": 1,
            "error": "payment required",
            "accepts": [
                {
                    "scheme": "exact",
                    "network": self.cfg.network,
                    "maxAmountRequired": str(amount),
                    "resource": f"{self.cfg.base_url}{resource}",
                    "description": "smalltts speech synthesis",
                    "mimeType": "audio/wav",
                    "payTo": self.cfg.pay_to,
                    "maxTimeoutSeconds": 300,
                    "asset": self.cfg.asset,
                    # EIP-712 domain the server verifies against (the website
                    # and sign_payment read these; x402 "exact" on EVM carries
                    # the asset domain in `extra`)
                    "extra": {"name": self.cfg.usdc_name,
                              "version": self.cfg.usdc_version},
                }
            ],
        }
        return base64.b64encode(json.dumps(payload).encode()).decode()

    def check(self, headers: dict, duration_sec: float, resource: str) -> Tuple[bool, Optional[str]]:
        """-> (allowed, payment_required_header_if_denied)."""
        if self.cfg.mode == "disabled":
            return True, None
        payment = headers.get("x-payment")
        if not payment:
            return False, self.payment_required_header(duration_sec, resource)
        if self.cfg.mode == "trust":
            return True, None
        if self.cfg.mode == "local":
            ok = self.verify_local(payment, duration_sec)
        else:
            ok = self._verify_with_facilitator(payment, duration_sec, resource)
        if ok:
            return True, None
        return False, self.payment_required_header(duration_sec, resource)

    @property
    def blocking(self) -> bool:
        """Whether check() may block (network or EC math) and should run off
        the event loop."""
        return self.cfg.mode in ("facilitator", "local")

    def build_typed_data(self, authorization: dict) -> dict:
        """The exact eth_signTypedData_v4 payload the web client signs
        (website/index.html signPayment) for a given authorization."""
        return _eip3009_typed_data(
            self.cfg.usdc_name, self.cfg.usdc_version,
            int(self.cfg.network.split(":")[1]), self.cfg.asset, authorization)

    def verify_local(self, payment_b64: str, duration_sec: float,
                     burn: bool = False) -> bool:
        """In-process EIP-3009 verification (no facilitator). Fail-closed:
        any malformed envelope, bad signature, wrong recipient/value/window,
        or replayed nonce denies the request.

        `burn=False` (the check() path) only VERIFIES — no side effects, so
        a request that later fails (queue full, inference error) neither
        consumes the nonce nor lands in the capture file; the client can
        retry with the same signed payment. `burn=True` (the settle() path,
        after successful synthesis) marks the nonce seen and archives the
        authorization for on-chain capture — the verify -> serve -> settle
        order the facilitator mode already follows (burning at
        check time charged clients for 503s)."""
        from smalltts_tpu_torch.serving import eth

        try:
            envelope = json.loads(base64.b64decode(payment_b64))
            if envelope.get("scheme") != "exact":
                return False
            if envelope.get("network") != self.cfg.network:
                return False
            payload = envelope["payload"]
            auth = payload["authorization"]
            signature = payload["signature"]
            # Enforce the ON-CHAIN signature shape, not just recoverability:
            # USDC's FiatToken ECRecover rejects high-s (EIP-2) and v outside
            # {27,28}, and ECDSA is malleable — (r, N-s, v^1) recovers the
            # same signer. Without this check a self-malleated signature
            # passes local verify, the server synthesizes, and the archived
            # authorization is uncapturable on-chain: free compute. Every
            # real signer (eth_signTypedData_v4 wallets, eth.sign_hash, the
            # website burner) emits low-s with v in {27,28} (0/1 raw recid
            # spellings normalize to those), so no legitimate client is cut.
            sig_bytes = eth._hexbytes(signature)
            if len(sig_bytes) != 65:
                return False
            s_val = int.from_bytes(sig_bytes[32:64], "big")
            if s_val > eth.N // 2:
                return False
            if sig_bytes[64] not in (0, 1, 27, 28):
                return False
            signer = eth.recover_typed_data(self.build_typed_data(auth), signature)
            if signer.lower() != str(auth["from"]).lower():
                return False
            if str(auth["to"]).lower() != self.cfg.pay_to.lower():
                return False
            if int(str(auth["value"])) < price_for_duration(duration_sec):
                return False
            now = time.time()
            if not (int(str(auth["validAfter"])) <= now < int(str(auth["validBefore"]))):
                return False
            # replay key = the CANONICAL 32-byte value the signature hashes
            # (eth._encode_value bytes32 coding), not the request's hex text:
            # '0x01..', '01..', and whitespace-embedded spellings all verify
            # against the same signature, so keying on the string would let
            # one payment replay under re-encodings.
            nonce = eth._hexbytes(auth["nonce"]).ljust(32, b"\x00")
            with self._nonce_lock:
                if nonce in self._seen_nonces:
                    return False
                if burn:
                    self._seen_nonces[nonce] = None
                    self._pending_nonces.discard(nonce)
                    while len(self._seen_nonces) > _NONCE_CAP:
                        self._seen_nonces.popitem(last=False)
                else:
                    # reserve: a concurrent duplicate of an in-flight
                    # payment denies immediately, BEFORE synthesis
                    if nonce in self._pending_nonces:
                        return False
                    self._pending_nonces.add(nonce)
        except Exception:
            return False
        if burn and self.cfg.capture_path:
            try:
                with open(self.cfg.capture_path, "a") as fh:
                    fh.write(json.dumps(
                        {"authorization": auth, "signature": signature,
                         "asset": self.cfg.asset, "network": self.cfg.network}
                    ) + "\n")
            except OSError:
                pass  # archiving is best-effort; the payment itself verified
        return True

    def _facilitator_body(self, payment_b64: str, duration_sec: float,
                          resource: str = "/synthesize") -> bytes:
        """The /verify and /settle request body (x402 v1 facilitator API):
        {x402Version, paymentPayload, paymentRequirements}."""
        payload = json.loads(base64.b64decode(payment_b64))
        return json.dumps(
            {
                "x402Version": 1,
                "paymentPayload": payload,
                "paymentRequirements": json.loads(
                    base64.b64decode(
                        self.payment_required_header(duration_sec, resource)
                    )
                )["accepts"][0],
            }
        ).encode()

    def _facilitator_post(self, endpoint: str, payment_b64: str,
                          duration_sec: float,
                          resource: str = "/synthesize") -> Optional[dict]:
        import urllib.request

        try:
            req = urllib.request.Request(
                f"{self.cfg.facilitator_url}{endpoint}",
                data=self._facilitator_body(payment_b64, duration_sec,
                                            resource),
                headers={"content-type": "application/json"},
            )
            with urllib.request.urlopen(req, timeout=10) as resp:
                return json.loads(resp.read())
        except Exception:
            return None  # fail closed: callers treat None as denial

    def _verify_with_facilitator(self, payment_b64: str, duration_sec: float,
                                 resource: str = "/synthesize") -> bool:
        resp = self._facilitator_post("/verify", payment_b64, duration_sec,
                                      resource)
        return bool(resp and resp.get("isValid", False))

    def settle(self, payment_b64: str, duration_sec: float,
               resource: str = "/synthesize") -> Optional[str]:
        """Capture the verified payment AFTER successful synthesis
        (settle-after-serve, like the reference's x402-axum middleware,
        main.rs:60-79). Returns the base64 X-PAYMENT-RESPONSE header value,
        or None if settlement failed (caller should 402). Trust mode settles
        nothing and returns a stub receipt.

        Local mode settles by re-verifying with burn=True: the nonce is
        consumed and the authorization archived only now — check() was
        side-effect-free, so a request that failed between check and settle
        (queue full, inference error) stays retryable with the same signed
        payment. Two concurrent requests racing one nonce both pass check;
        the race resolves here, where the second settle finds the nonce
        burned and the caller 402s."""
        if self.cfg.mode == "local":
            if not self.verify_local(payment_b64, duration_sec, burn=True):
                return None
            return base64.b64encode(
                json.dumps({"success": True, "network": self.cfg.network}).encode()
            ).decode()
        if self.cfg.mode != "facilitator":
            return base64.b64encode(
                json.dumps({"success": True, "network": self.cfg.network}).encode()
            ).decode()
        resp = self._facilitator_post("/settle", payment_b64, duration_sec,
                                      resource)
        if not resp or not resp.get("success", False):
            return None
        return base64.b64encode(json.dumps(resp).encode()).decode()

    def release(self, payment_b64: str) -> None:
        """Free a check-time nonce reservation after a request fails between
        check and settle (queue full, bad input, inference error) — the
        client can retry with the same signed payment. No-op for settled
        (burned) nonces and for non-local modes."""
        if self.cfg.mode != "local" or not payment_b64:
            return
        from smalltts_tpu_torch.serving import eth

        try:
            auth = json.loads(base64.b64decode(payment_b64))[
                "payload"]["authorization"]
            nonce = eth._hexbytes(auth["nonce"]).ljust(32, b"\x00")
        except Exception:
            return
        with self._nonce_lock:
            self._pending_nonces.discard(nonce)

    @property
    def enforcing(self) -> bool:
        """Whether payments are actually charged (facilitator capture or
        local burn) — the predicate for value-limiting behaviors like the
        streaming duration budget. Distinct from `blocking`, which is only
        about event-loop scheduling (the budget was keyed on
        blocking and held by coincidence)."""
        return self.cfg.mode in ("facilitator", "local")

    @property
    def settles(self) -> bool:
        """Whether successful requests must settle before the response
        (facilitator capture, or local-mode nonce burn + archive)."""
        return self.cfg.mode in ("facilitator", "local")

    def sign_payment(self, priv: int, accept: dict,
                     nonce: Optional[bytes] = None,
                     now: Optional[float] = None) -> str:
        """Client-side: produce the base64 X-PAYMENT envelope for a 402
        challenge's accepts[0] — the exact flow website/index.html implements
        in JS (burner wallet / injected wallet). Used by scripts/test_x402.py
        and the local-mode tests so client and server exercise the same
        typed-data contract."""
        import os as _os

        from smalltts_tpu_torch.serving import eth

        nonce = nonce if nonce is not None else _os.urandom(32)
        now = time.time() if now is None else now
        authorization = {
            "from": eth.address_from_priv(priv),
            "to": accept["payTo"],
            "value": str(accept["maxAmountRequired"]),
            "validAfter": "0",
            "validBefore": str(int(now) + int(accept.get("maxTimeoutSeconds", 300))),
            "nonce": "0x" + nonce.hex(),
        }
        extra = accept.get("extra") or {}
        typed = _eip3009_typed_data(
            extra.get("name", "USD Coin"), extra.get("version", "2"),
            int(accept["network"].split(":")[1]), accept["asset"], authorization)
        signature = eth.sign_typed_data(priv, typed)
        return base64.b64encode(json.dumps({
            "x402Version": 1,
            "scheme": accept["scheme"],
            "network": accept["network"],
            "payload": {"signature": signature, "authorization": authorization},
        }).encode()).decode()

    def discovery(self) -> dict:
        """GET /.well-known/x402 payload (main.rs:158-165)."""
        return {
            "version": 1,
            "resources": [f"{self.cfg.base_url}/synthesize"],
            "instructions": (
                "# smalltts\n\nText-to-speech API. POST /synthesize?duration=N "
                "with multipart audio + text.\n\nPricing: $0.01/min of "
                "generated audio."
            ),
        }
