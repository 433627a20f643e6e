// Native S-expression parser: C++ implementation of the control-plane
// codec (exact semantics of aiko_services_tpu_torch/utils/sexpr.py::parse).
//
// The port's own copy of the JAX package's native/sexpr_codec.cpp: every
// inbound control message is parsed, so the hottest host path that is not
// tensor work gets a native fast path.  The Python wrapper
// (native/__init__.py) loads this extension once it is built and leaves
// the pure-Python tokenizer in use otherwise; both must stay behaviorally
// identical (tests/test_torch_native.py runs the shared corpus against
// both).
//
// Contract with the wrapper: parse_bytes(bytes) -> (command, parameters).
// Text is latin-1 (byte-per-char), so canonical "len:data" symbols are
// binary-safe.  ParseError is injected via set_parse_error() so native
// and Python paths raise the same exception type.

#define PY_SSIZE_T_CLEAN
#include <Python.h>

#include <string>
#include <vector>

namespace {

PyObject *parse_error = nullptr;  // utils.sexpr.ParseError

struct Tokenizer {
    const char *text;
    Py_ssize_t pos;
    Py_ssize_t length;
};

bool is_space(char ch) {
    return ch == ' ' || ch == '\t' || ch == '\r' || ch == '\n';
}

bool is_delim(char ch) {
    return is_space(ch) || ch == '(' || ch == ')' || ch == '"';
}

void skip_whitespace(Tokenizer &tok) {
    while (tok.pos < tok.length && is_space(tok.text[tok.pos])) {
        tok.pos++;
    }
}

PyObject *raise_parse_error(const char *message, Py_ssize_t offset) {
    PyErr_Format(parse_error ? parse_error : PyExc_ValueError,
                 "%s at offset %zd", message, offset);
    return nullptr;
}

PyObject *latin1(const char *data, Py_ssize_t size) {
    return PyUnicode_DecodeLatin1(data, size, nullptr);
}

// positioned on the opening quote; returns str
PyObject *read_quoted(Tokenizer &tok) {
    Py_ssize_t pos = tok.pos + 1;
    std::string out;
    while (pos < tok.length) {
        char ch = tok.text[pos];
        if (ch == '\\' && pos + 1 < tok.length) {
            out.push_back(tok.text[pos + 1]);
            pos += 2;
            continue;
        }
        if (ch == '"') {
            tok.pos = pos + 1;
            return latin1(out.data(), (Py_ssize_t)out.size());
        }
        out.push_back(ch);
        pos++;
    }
    return raise_parse_error("Unterminated quoted string", tok.pos);
}

// returns str (atom or canonical "len:data" payload)
PyObject *read_atom(Tokenizer &tok) {
    const char *text = tok.text;
    Py_ssize_t pos = tok.pos;
    Py_ssize_t start = pos;
    while (pos < tok.length && !is_delim(text[pos])) {
        char ch = text[pos];
        pos++;
        if (ch == ':' && pos > start + 1) {
            // candidate canonical symbol: digits before the colon
            bool all_digits = true;
            for (Py_ssize_t i = start; i < pos - 1; i++) {
                if (text[i] < '0' || text[i] > '9') {
                    all_digits = false;
                    break;
                }
            }
            if (all_digits) {
                long long size = 0;
                for (Py_ssize_t i = start; i < pos - 1; i++) {
                    size = size * 10 + (text[i] - '0');
                    if (size > tok.length) break;  // overflow guard
                }
                Py_ssize_t end = pos + (Py_ssize_t)size;
                if (end > tok.length) {
                    return raise_parse_error(
                        "Canonical symbol overruns payload", start);
                }
                tok.pos = end;
                return latin1(text + pos, end - pos);
            }
        }
    }
    tok.pos = pos;
    return latin1(text + start, pos - start);
}

bool is_keyword_key(PyObject *item) {
    if (!PyUnicode_Check(item)) return false;
    Py_ssize_t size = PyUnicode_GET_LENGTH(item);
    if (size < 2) return false;
    return PyUnicode_READ_CHAR(item, size - 1) == ':';
}

PyObject *parse_expression(Tokenizer &tok);

// positioned past '('; returns list or keyword dict
PyObject *parse_list(Tokenizer &tok) {
    PyObject *items = PyList_New(0);
    if (!items) return nullptr;
    for (;;) {
        skip_whitespace(tok);
        if (tok.pos >= tok.length) {
            Py_DECREF(items);
            return raise_parse_error("Unterminated list", tok.pos);
        }
        if (tok.text[tok.pos] == ')') {
            tok.pos++;
            break;
        }
        PyObject *item = parse_expression(tok);
        if (!item) {
            Py_DECREF(items);
            return nullptr;
        }
        int failed = PyList_Append(items, item);
        Py_DECREF(item);
        if (failed) {
            Py_DECREF(items);
            return nullptr;
        }
    }
    // alternating "name:" keys fold into a dict (even, non-empty lists)
    Py_ssize_t count = PyList_GET_SIZE(items);
    if (count > 0 && count % 2 == 0) {
        bool keyword_mode = true;
        for (Py_ssize_t i = 0; i < count; i += 2) {
            if (!is_keyword_key(PyList_GET_ITEM(items, i))) {
                keyword_mode = false;
                break;
            }
        }
        if (keyword_mode) {
            PyObject *dict = PyDict_New();
            if (!dict) {
                Py_DECREF(items);
                return nullptr;
            }
            for (Py_ssize_t i = 0; i < count; i += 2) {
                PyObject *key_full = PyList_GET_ITEM(items, i);
                PyObject *key = PyUnicode_Substring(
                    key_full, 0, PyUnicode_GET_LENGTH(key_full) - 1);
                if (!key || PyDict_SetItem(
                        dict, key, PyList_GET_ITEM(items, i + 1))) {
                    Py_XDECREF(key);
                    Py_DECREF(dict);
                    Py_DECREF(items);
                    return nullptr;
                }
                Py_DECREF(key);
            }
            Py_DECREF(items);
            return dict;
        }
    }
    return items;
}

PyObject *parse_expression(Tokenizer &tok) {
    skip_whitespace(tok);
    if (tok.pos >= tok.length) {
        return raise_parse_error("Unexpected end of payload", tok.pos);
    }
    char ch = tok.text[tok.pos];
    if (ch == '(') {
        tok.pos++;
        return parse_list(tok);
    }
    if (ch == '"') {
        return read_quoted(tok);
    }
    return read_atom(tok);
}

// parse_bytes(payload: bytes) -> (command, parameters)
PyObject *py_parse_bytes(PyObject *, PyObject *arg) {
    char *data;
    Py_ssize_t length;
    if (PyBytes_AsStringAndSize(arg, &data, &length) < 0) {
        return nullptr;
    }
    Tokenizer tok{data, 0, length};
    skip_whitespace(tok);
    if (tok.pos >= tok.length) {
        return Py_BuildValue("(s[])", "");
    }
    PyObject *expression = parse_expression(tok);
    if (!expression) return nullptr;
    skip_whitespace(tok);
    if (tok.pos < tok.length) {
        Py_DECREF(expression);
        return raise_parse_error("Trailing data", tok.pos);
    }
    if (PyUnicode_Check(expression)) {
        PyObject *result = Py_BuildValue("(N[])", expression);
        return result;
    }
    if (PyDict_Check(expression)) {
        return Py_BuildValue("(s[N])", "", expression);
    }
    Py_ssize_t count = PyList_GET_SIZE(expression);
    if (count == 0) {
        Py_DECREF(expression);
        return Py_BuildValue("(s[])", "");
    }
    PyObject *head = PyList_GET_ITEM(expression, 0);
    if (!PyUnicode_Check(head)) {
        return Py_BuildValue("(sN)", "", expression);
    }
    PyObject *tail = PyList_GetSlice(expression, 1, count);
    if (!tail) {
        Py_DECREF(expression);
        return nullptr;
    }
    Py_INCREF(head);
    Py_DECREF(expression);
    return Py_BuildValue("(NN)", head, tail);
}

PyObject *py_set_parse_error(PyObject *, PyObject *arg) {
    Py_XDECREF(parse_error);
    Py_INCREF(arg);
    parse_error = arg;
    Py_RETURN_NONE;
}

PyMethodDef methods[] = {
    {"parse_bytes", py_parse_bytes, METH_O,
     "parse_bytes(payload: bytes) -> (command, parameters)"},
    {"set_parse_error", py_set_parse_error, METH_O,
     "Install the exception class raised on malformed payloads"},
    {nullptr, nullptr, 0, nullptr},
};

PyModuleDef module_def = {
    PyModuleDef_HEAD_INIT, "_sexpr_native",
    "Native S-expression parser (C++)", -1, methods,
    nullptr, nullptr, nullptr, nullptr,
};

}  // namespace

PyMODINIT_FUNC PyInit__sexpr_native(void) {
    return PyModule_Create(&module_def);
}
