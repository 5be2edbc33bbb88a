"""The Dynamo shopping cart, end to end with the KVClient session API.

The canonical workload behind the paper (and Dynamo §4.4): a cart must
*never lose an added item*, even when two devices write through different
replicas during a partition.  This walkthrough shows the full client
contract:

  1. sessions   — ``KVClient`` owns the client id/counter and the proxy;
  2. tokens     — GET returns an *opaque* ``CausalContext``; the client
                  carries it (even across processes, as bytes) and hands it
                  back on PUT — it never inspects it;
  3. siblings   — concurrent carts survive as siblings; the app merges them
                  (set union) and writes the merge with the combined token;
  4. batching   — the checkout pipeline writes order/receipt/inventory keys
                  in one ``put_many`` (one vectorized coordinator update).

The PyTorch port of ``examples/shopping_cart.py``: the same walkthrough and
the same output, with the cluster's batched planes (put_many, get_many)
on ``--device``.

Run:  PYTHONPATH=src python examples_torch/shopping_cart.py [--device cpu]
"""
import argparse
import json

from repro_torch.core import DVV_MECHANISM
from repro_torch.store import CausalContext, KVClient, KVCluster, SimNetwork


def cart_encode(items):
    return json.dumps(sorted(items))


def cart_decode(res):
    """Merge sibling carts: set union — the Dynamo resolution rule."""
    merged = set()
    for blob in res.values:
        merged |= set(json.loads(blob))
    return merged


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    store = KVCluster(("r1", "r2", "r3"), DVV_MECHANISM,
                      network=SimNetwork(seed=7), device=args.device)

    # --- 1. one shopper, two devices --------------------------------------
    phone = KVClient(store, "alice-phone", via="r1")
    laptop = KVClient(store, "alice-laptop", via="r3")

    phone.put("cart/alice", cart_encode({"book"}))
    store.deliver_replication()

    # the laptop reads the cart and gets an opaque causal token with it
    res = laptop.get("cart/alice", quorum=2)
    print(f"laptop sees {cart_decode(res)} with token {res.context!r}")

    # tokens are wire-encodable: O(R) bytes, independent of sibling count —
    # a real client ships this blob to the browser and back
    blob = res.context.to_bytes()
    token = CausalContext.from_bytes(blob)
    print(f"token travels as {len(blob)} bytes")

    # --- 2. a partition splits the devices --------------------------------
    store.network.partition({"r1"}, {"r2", "r3"})
    phone.put("cart/alice", cart_encode({"book", "pen"}),
              context=token, coordinator="r1")            # phone adds a pen
    laptop.put("cart/alice", cart_encode({"book", "mug"}),
               context=token, coordinator="r3")           # laptop adds a mug
    store.network.heal()
    store.antientropy_round()

    # both writes survive as siblings — nothing was lost (the paper's point;
    # an LWW store would have silently dropped one device's item)
    res = phone.get("cart/alice", quorum=3)
    print(f"after heal: {res.siblings} sibling carts -> merged "
          f"{cart_decode(res)}")
    assert cart_decode(res) == {"book", "pen", "mug"}

    # the app-level merge becomes a new write that *supersedes* both siblings
    # because it carries the combined token
    phone.put("cart/alice", cart_encode(cart_decode(res)), context=res.context)
    store.deliver_replication()
    res = laptop.get("cart/alice", quorum=3)
    assert res.siblings == 1
    print(f"resolved everywhere: {cart_decode(res)}")

    # --- 3. checkout: batched multi-key writes ----------------------------
    # Checkout touches many keys; put_many groups them by coordinator and runs
    # each group as one vectorized store update + one replication payload per
    # destination replica.
    cart = laptop.get("cart/alice")
    order_keys = {
        "order/1042": (cart_encode(cart_decode(cart)), None),
        "receipt/1042": ("paid:3_items", None),
        "inventory/book": ("decrement", None),
        "inventory/pen": ("decrement", None),
        "inventory/mug": ("decrement", None),
        # clearing the cart is causally AFTER what we just read: pass the token
        "cart/alice": (cart_encode(set()), cart.context),
    }
    acks = laptop.put_many(order_keys)
    store.deliver_replication()
    print(f"checkout wrote {len(acks)} keys via "
          f"{sorted({a.coordinator for a in acks.values()})}")

    # the multi-key fetch takes the batched read plane: keys grouped by their
    # read-quorum set, ONE stacked quorum-merge sweep per group (instead of a
    # per-key merge), per-key results sliced out — and with repair=True any
    # replica the merge finds stale is healed by one consolidated push
    # (Dynamo-style read-repair: hot keys converge at read latency)
    batch = laptop.get_many(list(order_keys), quorum=2, repair=True)
    store.deliver_replication()                 # flush the repair pushes
    assert batch["cart/alice"].values == (cart_encode(set()),)
    assert batch["order/1042"].siblings == 1
    print(f"cart is empty, order persisted: {batch['order/1042'].values[0]}")

    # deterministic conflict resolution, documented: GetResult.value picks the
    # sibling maximal in (wall_time, clock, value) — stable across replicas
    print(f"resolved register view of the receipt: "
          f"{batch['receipt/1042'].value}")


if __name__ == "__main__":
    main()
