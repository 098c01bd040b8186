"""The frozen operation and byte counts against hand counts at a small
shape."""
from roofline import flops as fl

M = {"L": 2, "d": 8, "H": 4, "Hkv": 2, "Dh": 2, "ff": 16, "V": 32}


def test_layer_and_head_params():
    # q 8x8, k 8x4, v 8x4, o 8x8, three 8x16 MLP products
    assert fl.layer_params(M) == 64 + 32 + 32 + 64 + 3 * 128
    assert fl.head_params(M) == 8 * 32


def test_attention_by_position():
    assert fl.keys_upto(0, 3) == 1 + 2 + 3
    assert fl.keys_upto(2, 4) == 3 + 4
    assert fl.attn_flops(M, 2, 4) == 4 * 4 * 2 * 7


def test_decode_and_chunk():
    per_tok = 2 * (2 * fl.layer_params(M) + fl.head_params(M))
    assert fl.decode_token_flops(M, 5) == per_tok + 2 * 4 * 4 * 2 * 6
    c = fl.prefill_chunk_flops(M, 4, 6, 1)
    assert c == (2 * 2 * fl.layer_params(M) * 2 + 2 * fl.head_params(M)
                 + 2 * 4 * 4 * 2 * (5 + 6))


def test_k3_k4_bytes():
    f, b = fl.k3_launch(M, [0, 3])
    row = 2 * 2 * 2                       # Hkv x Dh x bf16
    qo = 4 * 2 * 2 * 2                    # H x Dh x bf16, q in and o out
    assert b == (1 * row * 2 + qo) + (4 * row * 2 + qo)
    assert f == 4 * 4 * 2 * (1 + 4)
    f, b = fl.k4_launch(M, 2, 5)
    assert b == 5 * row * 2 + 3 * qo
    assert f == 4 * 4 * 2 * (3 + 4 + 5)


def test_train_step():
    f = fl.train_step_flops(M, 2, 3)
    assert f == (6 * (2 * fl.layer_params(M) + fl.head_params(M)) * 6
                 + 3 * 2 * 2 * 4 * 4 * 2 * 6)
