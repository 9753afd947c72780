/* Native write-path cores for the always-on telemetry instruments.
 *
 * Two small CPython types keep the per-record cost of the ledger and the
 * span tracer at native speed while ALL aggregation stays in Python:
 *
 *   LedgerCore  — per-thread int64 rings, stride 7, exactly the layout of
 *                 ledger._Ring (kind, verb-code, step, t0, t1, a, b with
 *                 per-kind write counters for exact drop accounting).
 *   TraceCore   — per-thread object rings, stride (name, cat, attrs) +
 *                 (t0, dur) int64 pairs; FastSpan is the C counterpart of
 *                 trace.Span (same public surface: set(), dur_us, dur_ms,
 *                 elapsed_ms) whose __enter__/__exit__ do one clock read
 *                 each and five slot stores, no Python frame.
 *
 * Threading model: a writer only ever touches its own ring.  The ring is
 * found through the interpreter's per-thread dict (PyThreadState_GetDict)
 * keyed by the core object; a one-entry (thread-state, ring) cache makes
 * the common single-writer lookup two pointer compares.  The dict value
 * is a capsule whose destructor runs when the thread dies and PARKS the
 * ring on the core's free list for adoption by the next new thread —
 * identical lifecycle to the pure-Python _RingHandle, so short-lived
 * executor threads never pay ring preallocation twice and dead threads'
 * unread records survive until a clear().
 *
 * Everything here runs under the GIL: drain() never releases it, so the
 * copies it takes are exact (the pure-Python path additionally defends
 * against the slice-copy race; here there is no window at all).
 *
 * Clock: clock_gettime(CLOCK_MONOTONIC) — the same source CPython uses
 * for time.monotonic_ns() on Linux, so C-recorded spans and Python-side
 * epoch anchors stay mutually consistent.
 */

#define PY_SSIZE_T_CLEAN
#include <Python.h>
#include <structmember.h>

#include <stdint.h>
#include <string.h>
#include <time.h>

static inline int64_t mono_ns(void) {
    struct timespec ts;
    clock_gettime(CLOCK_MONOTONIC, &ts);
    return (int64_t)ts.tv_sec * 1000000000LL + (int64_t)ts.tv_nsec;
}

/* threading.current_thread, resolved once at module init (ring
 * creation/adoption only — never on the record path). */
static PyObject *g_current_thread = NULL;

static PyObject *cur_thread_name(void) {
    PyObject *t = PyObject_CallNoArgs(g_current_thread);
    if (t == NULL)
        return NULL;
    PyObject *name = PyObject_GetAttrString(t, "name");
    Py_DECREF(t);
    return name;
}

/* ---------------------------------------------------------------- ledger */

#define LSTRIDE 7
#define NKINDS 8

typedef struct {
    int64_t *data;                    /* phys * LSTRIDE int64 slots */
    int64_t cursor, base;
    int64_t cap, phys;
    int64_t kind_writes[NKINDS], kind_base[NKINDS];
    /* Thread-resident recording context (the C counterpart of the
     * Python _Tls verb/step): scopes swap it, fixed-kind record
     * methods read it — so a protocol hook is ONE C call with no
     * Python-side context plumbing. */
    int64_t ctx_code, ctx_step;
} LRing;

/* Record kinds — must match ledger.py's _K_* constants. */
enum {
    K_PACK = 0, K_UNPACK = 1, K_ENCODE = 2, K_DECODE = 3,
    K_CALL = 4, K_HANDLER = 5, K_RETRY = 6, K_WINDOW = 7,
};

/* swap_ctx() step sentinel: keep the current step (a nested scope with
 * no step of its own inherits the outer one). */
#define STEP_KEEP (-2)

typedef struct {
    PyObject_HEAD
    int64_t cap;
    LRing **all;   Py_ssize_t n_all, sz_all;
    LRing **freel; Py_ssize_t n_free, sz_free;
    PyThreadState *cache_ts;          /* one-entry TLS lookup cache */
    LRing *cache_ring;
} LedgerCoreObject;

typedef struct {
    LRing *ring;
    PyObject *core;                   /* strong ref: park target outlives us */
} LRingBox;

static const char LCAP_NAME[] = "tepdist.fastobs.lring";

static LRing *lring_new(int64_t cap) {
    LRing *r = (LRing *)calloc(1, sizeof(LRing));
    if (r == NULL)
        return NULL;
    r->cap = cap;
    r->phys = cap + 1;
    r->data = (int64_t *)malloc(sizeof(int64_t) * LSTRIDE * (size_t)r->phys);
    if (r->data == NULL) {
        free(r);
        return NULL;
    }
    r->ctx_code = 0;                  /* _unattributed */
    r->ctx_step = -1;                 /* no step */
    return r;
}

static int ptr_push(void ***arr, Py_ssize_t *n, Py_ssize_t *sz, void *p) {
    if (*n == *sz) {
        Py_ssize_t ns = *sz ? *sz * 2 : 8;
        void **na = (void **)realloc(*arr, sizeof(void *) * (size_t)ns);
        if (na == NULL)
            return -1;
        *arr = na;
        *sz = ns;
    }
    (*arr)[(*n)++] = p;
    return 0;
}

static void lring_capsule_destruct(PyObject *capsule) {
    LRingBox *box = (LRingBox *)PyCapsule_GetPointer(capsule, LCAP_NAME);
    if (box == NULL) {
        PyErr_Clear();
        return;
    }
    LedgerCoreObject *core = (LedgerCoreObject *)box->core;
    if (ptr_push((void ***)&core->freel, &core->n_free, &core->sz_free,
                 box->ring) < 0) {
        /* Out of memory parking: the ring stays in `all` (records remain
         * visible) but is never adopted.  Harmless beyond the leak. */
    }
    if (core->cache_ring == box->ring) {
        core->cache_ts = NULL;
        core->cache_ring = NULL;
    }
    Py_DECREF(box->core);
    free(box);
}

static LRing *ledger_tls_ring(LedgerCoreObject *self) {
    PyThreadState *ts = PyThreadState_Get();
    if (ts == self->cache_ts)
        return self->cache_ring;
    PyObject *td = PyThreadState_GetDict();
    if (td == NULL) {
        PyErr_SetString(PyExc_RuntimeError, "no thread-state dict");
        return NULL;
    }
    PyObject *cap = PyDict_GetItemWithError(td, (PyObject *)self);
    LRing *r;
    if (cap != NULL) {
        LRingBox *box = (LRingBox *)PyCapsule_GetPointer(cap, LCAP_NAME);
        if (box == NULL)
            return NULL;
        r = box->ring;
    } else {
        if (PyErr_Occurred())
            return NULL;
        if (self->n_free > 0) {
            r = self->freel[--self->n_free];   /* adopt a parked ring */
            r->ctx_code = 0;          /* never inherit a dead thread's ctx */
            r->ctx_step = -1;
        } else {
            r = lring_new(self->cap);
            if (r == NULL) {
                PyErr_NoMemory();
                return NULL;
            }
            if (ptr_push((void ***)&self->all, &self->n_all, &self->sz_all,
                         r) < 0) {
                free(r->data);
                free(r);
                PyErr_NoMemory();
                return NULL;
            }
        }
        LRingBox *box = (LRingBox *)malloc(sizeof(LRingBox));
        if (box == NULL) {
            PyErr_NoMemory();
            return NULL;
        }
        box->ring = r;
        box->core = (PyObject *)self;
        Py_INCREF(self);
        PyObject *capo = PyCapsule_New(box, LCAP_NAME, lring_capsule_destruct);
        if (capo == NULL) {
            Py_DECREF(self);
            free(box);
            return NULL;
        }
        if (PyDict_SetItem(td, (PyObject *)self, capo) < 0) {
            Py_DECREF(capo);
            return NULL;
        }
        Py_DECREF(capo);
    }
    self->cache_ts = ts;
    self->cache_ring = r;
    return r;
}

static int LedgerCore_init(LedgerCoreObject *self, PyObject *args,
                           PyObject *kwds) {
    long long cap = 0;
    static char *kwlist[] = {"ring_records", NULL};
    if (!PyArg_ParseTupleAndKeywords(args, kwds, "L", kwlist, &cap))
        return -1;
    if (cap < 1) {
        PyErr_SetString(PyExc_ValueError, "ring_records must be >= 1");
        return -1;
    }
    self->cap = (int64_t)cap;
    return 0;
}

static void LedgerCore_dealloc(LedgerCoreObject *self) {
    for (Py_ssize_t i = 0; i < self->n_all; i++) {
        free(self->all[i]->data);
        free(self->all[i]);
    }
    free(self->all);
    free(self->freel);
    Py_TYPE(self)->tp_free((PyObject *)self);
}

static PyObject *LedgerCore_rec(LedgerCoreObject *self,
                                PyObject *const *args, Py_ssize_t nargs) {
    if (nargs != 7) {
        PyErr_SetString(PyExc_TypeError,
                        "rec(kind, code, step, t0, t1, a, b)");
        return NULL;
    }
    int64_t v[LSTRIDE];
    for (int i = 0; i < LSTRIDE; i++) {
        v[i] = (int64_t)PyLong_AsLongLong(args[i]);
        if (v[i] == -1 && PyErr_Occurred())
            return NULL;
    }
    if (v[0] < 0 || v[0] >= NKINDS) {
        PyErr_SetString(PyExc_ValueError, "bad record kind");
        return NULL;
    }
    LRing *r = ledger_tls_ring(self);
    if (r == NULL)
        return NULL;
    int64_t c = r->cursor;
    memcpy(r->data + (c % r->phys) * LSTRIDE, v, sizeof(v));
    r->kind_writes[v[0]]++;
    r->cursor = c + 1;              /* publish after the slot writes */
    Py_RETURN_NONE;
}

static inline void lrec(LRing *r, int64_t kind, int64_t code, int64_t step,
                        int64_t t0, int64_t t1, int64_t a, int64_t b) {
    int64_t c = r->cursor;
    int64_t *slot = r->data + (c % r->phys) * LSTRIDE;
    slot[0] = kind;
    slot[1] = code;
    slot[2] = step;
    slot[3] = t0;
    slot[4] = t1;
    slot[5] = a;
    slot[6] = b;
    r->kind_writes[kind]++;
    r->cursor = c + 1;              /* publish after the slot writes */
}

/* args: exactly `need` int64s into v (with up to `opt` trailing ones
 * optional, zero-filled).  Returns 0 on success. */
static int grab_ints(PyObject *const *args, Py_ssize_t nargs,
                     int need, int opt, int64_t *v) {
    if (nargs < need - opt || nargs > need) {
        PyErr_SetString(PyExc_TypeError, "wrong argument count");
        return -1;
    }
    for (int i = 0; i < need; i++) {
        if (i < nargs) {
            v[i] = (int64_t)PyLong_AsLongLong(args[i]);
            if (v[i] == -1 && PyErr_Occurred())
                return -1;
        } else {
            v[i] = 0;
        }
    }
    return 0;
}

/* rec_pack(hb, bb, t0, t1) — and rec_unpack — use the ring context for
 * verb/step, so a protocol hook is a single C call. */
static PyObject *ledger_rec_wire(LedgerCoreObject *self,
                                 PyObject *const *args, Py_ssize_t nargs,
                                 int64_t kind) {
    int64_t v[4];
    if (grab_ints(args, nargs, 4, 0, v) < 0)
        return NULL;
    LRing *r = ledger_tls_ring(self);
    if (r == NULL)
        return NULL;
    lrec(r, kind, r->ctx_code, r->ctx_step, v[2], v[3], v[0], v[1]);
    Py_RETURN_NONE;
}

static PyObject *LedgerCore_rec_pack(LedgerCoreObject *self,
                                     PyObject *const *args,
                                     Py_ssize_t nargs) {
    return ledger_rec_wire(self, args, nargs, K_PACK);
}

static PyObject *LedgerCore_rec_unpack(LedgerCoreObject *self,
                                       PyObject *const *args,
                                       Py_ssize_t nargs) {
    return ledger_rec_wire(self, args, nargs, K_UNPACK);
}

static PyObject *LedgerCore_rec_encode(LedgerCoreObject *self,
                                       PyObject *const *args,
                                       Py_ssize_t nargs) {
    int64_t v[3];                     /* t0, t1, copies (optional) */
    if (grab_ints(args, nargs, 3, 1, v) < 0)
        return NULL;
    LRing *r = ledger_tls_ring(self);
    if (r == NULL)
        return NULL;
    lrec(r, K_ENCODE, r->ctx_code, r->ctx_step, v[0], v[1], v[2], 0);
    Py_RETURN_NONE;
}

static PyObject *LedgerCore_rec_decode(LedgerCoreObject *self,
                                       PyObject *const *args,
                                       Py_ssize_t nargs) {
    int64_t v[2];
    if (grab_ints(args, nargs, 2, 0, v) < 0)
        return NULL;
    LRing *r = ledger_tls_ring(self);
    if (r == NULL)
        return NULL;
    lrec(r, K_DECODE, r->ctx_code, r->ctx_step, v[0], v[1], 0, 0);
    Py_RETURN_NONE;
}

/* rec_scope(kind, t0): the _VerbScope exit record — t1 is taken here
 * (one fewer Python clock call), verb/step come from the ring context,
 * which the caller restores AFTERWARDS. */
static PyObject *LedgerCore_rec_scope(LedgerCoreObject *self,
                                      PyObject *const *args,
                                      Py_ssize_t nargs) {
    int64_t v[2];
    if (grab_ints(args, nargs, 2, 0, v) < 0)
        return NULL;
    if (v[0] < 0 || v[0] >= NKINDS) {
        PyErr_SetString(PyExc_ValueError, "bad record kind");
        return NULL;
    }
    int64_t t1 = mono_ns();
    LRing *r = ledger_tls_ring(self);
    if (r == NULL)
        return NULL;
    lrec(r, v[0], r->ctx_code, r->ctx_step, v[1], t1, 0, 0);
    Py_RETURN_NONE;
}

/* rec_retry(code, backoff_us): explicit verb code, context step. */
static PyObject *LedgerCore_rec_retry(LedgerCoreObject *self,
                                      PyObject *const *args,
                                      Py_ssize_t nargs) {
    int64_t v[2];
    if (grab_ints(args, nargs, 2, 0, v) < 0)
        return NULL;
    LRing *r = ledger_tls_ring(self);
    if (r == NULL)
        return NULL;
    lrec(r, K_RETRY, v[0], r->ctx_step, 0, 0, v[1], 0);
    Py_RETURN_NONE;
}

/* swap_ctx(code, step) -> (prev_code, prev_step).  step == -2 keeps the
 * current step (a scope with no step of its own inherits the outer). */
static PyObject *LedgerCore_swap_ctx(LedgerCoreObject *self,
                                     PyObject *const *args,
                                     Py_ssize_t nargs) {
    int64_t v[2];
    if (grab_ints(args, nargs, 2, 0, v) < 0)
        return NULL;
    LRing *r = ledger_tls_ring(self);
    if (r == NULL)
        return NULL;
    PyObject *prev = Py_BuildValue("LL", (long long)r->ctx_code,
                                   (long long)r->ctx_step);
    if (prev == NULL)
        return NULL;
    r->ctx_code = v[0];
    if (v[1] != STEP_KEEP)
        r->ctx_step = v[1];
    return prev;
}

/* set_step(step) -> prev_step.  The _StepScope/_StepHint context. */
static PyObject *LedgerCore_set_step(LedgerCoreObject *self,
                                     PyObject *const *args,
                                     Py_ssize_t nargs) {
    int64_t v[1];
    if (grab_ints(args, nargs, 1, 0, v) < 0)
        return NULL;
    LRing *r = ledger_tls_ring(self);
    if (r == NULL)
        return NULL;
    int64_t prev = r->ctx_step;
    r->ctx_step = v[0];
    return PyLong_FromLongLong(prev);
}

/* LedgerScope: one-shot C context manager covering every ledger scope
 * shape — verb scopes (kind K_CALL/K_HANDLER: set verb+maybe step,
 * record the interval), step windows (K_WINDOW: set step, record the
 * window), and tag-only step hints (kind -1: set step, record nothing).
 * Enter saves the full ring context and exit restores it, so nesting
 * behaves exactly like the Python scope classes. */
typedef struct {
    PyObject_HEAD
    LedgerCoreObject *core;           /* strong */
    int64_t kind;                     /* K_* record kind, or -1 = hint */
    int64_t code, step;               /* step STEP_KEEP = inherit outer */
    int64_t t0;
    int64_t prev_code, prev_step;
} LedgerScopeObject;

static PyTypeObject LedgerScope_Type;   /* fwd */

static void LedgerScope_dealloc(LedgerScopeObject *self) {
    Py_XDECREF(self->core);
    Py_TYPE(self)->tp_free((PyObject *)self);
}

static PyObject *LedgerScope_enter(LedgerScopeObject *self, PyObject *noarg) {
    (void)noarg;
    LRing *r = ledger_tls_ring(self->core);
    if (r == NULL)
        return NULL;
    self->prev_code = r->ctx_code;
    self->prev_step = r->ctx_step;
    if (self->kind == K_CALL || self->kind == K_HANDLER)
        r->ctx_code = self->code;
    if (self->step != STEP_KEEP)
        r->ctx_step = self->step;
    if (self->kind >= 0)
        self->t0 = mono_ns();
    Py_INCREF(self);
    return (PyObject *)self;
}

static PyObject *LedgerScope_exit(LedgerScopeObject *self,
                                  PyObject *const *args, Py_ssize_t nargs) {
    (void)args;
    (void)nargs;
    LRing *r = ledger_tls_ring(self->core);
    if (r == NULL)
        return NULL;
    if (self->kind >= 0) {
        /* Record BEFORE restoring: the scope's own verb/step are the
         * live context.  Window records carry code 0 (they describe the
         * step, not a verb) — same as the Python _StepScope. */
        int64_t code = self->kind == K_WINDOW ? 0 : r->ctx_code;
        lrec(r, self->kind, code, r->ctx_step, self->t0, mono_ns(), 0, 0);
    }
    r->ctx_code = self->prev_code;
    r->ctx_step = self->prev_step;
    Py_RETURN_FALSE;
}

static PyMethodDef LedgerScope_methods[] = {
    {"__enter__", (PyCFunction)LedgerScope_enter, METH_NOARGS, NULL},
    {"__exit__", (PyCFunction)LedgerScope_exit, METH_FASTCALL, NULL},
    {NULL, NULL, 0, NULL},
};

static PyTypeObject LedgerScope_Type = {
    PyVarObject_HEAD_INIT(NULL, 0)
    .tp_name = "_tepdist_torch_fastobs.LedgerScope",
    .tp_basicsize = sizeof(LedgerScopeObject),
    .tp_flags = Py_TPFLAGS_DEFAULT,
    .tp_doc = "One-shot ledger context scope (verb / step / hint).",
    .tp_dealloc = (destructor)LedgerScope_dealloc,
    .tp_methods = LedgerScope_methods,
};

/* scope(kind, code, step) -> LedgerScope.  kind -1 = tag-only hint. */
static PyObject *LedgerCore_scope(LedgerCoreObject *self,
                                  PyObject *const *args, Py_ssize_t nargs) {
    int64_t v[3];
    if (grab_ints(args, nargs, 3, 0, v) < 0)
        return NULL;
    if (v[0] >= NKINDS) {
        PyErr_SetString(PyExc_ValueError, "bad scope kind");
        return NULL;
    }
    LedgerScopeObject *sc =
        (LedgerScopeObject *)LedgerScope_Type.tp_alloc(&LedgerScope_Type, 0);
    if (sc == NULL)
        return NULL;
    Py_INCREF(self);
    sc->core = self;
    sc->kind = v[0];
    sc->code = v[1];
    sc->step = v[2];
    sc->t0 = 0;
    sc->prev_code = 0;
    sc->prev_step = -1;
    return (PyObject *)sc;
}

static PyObject *LedgerCore_drain(LedgerCoreObject *self, PyObject *noarg) {
    /* -> (records, kind_lost): records is a time-unordered list of
     * 7-tuples matching the Python ring layout; kind_lost[k] is the
     * exact number of kind-k records overwritten since the last clear()
     * (writes minus survivors — the GIL is held throughout, so unlike
     * the pure-Python drain there is no torn-slot window to subtract). */
    (void)noarg;
    PyObject *recs = PyList_New(0);
    if (recs == NULL)
        return NULL;
    int64_t kind_lost[NKINDS] = {0};
    for (Py_ssize_t ri = 0; ri < self->n_all; ri++) {
        LRing *r = self->all[ri];
        int64_t cur = r->cursor;
        int64_t lo = r->base;
        if (cur - r->cap > lo)
            lo = cur - r->cap;
        int64_t surv[NKINDS] = {0};
        for (int64_t c = lo; c < cur; c++) {
            const int64_t *slot = r->data + (c % r->phys) * LSTRIDE;
            surv[slot[0]]++;
            PyObject *t = PyTuple_New(LSTRIDE);
            if (t == NULL)
                goto fail;
            for (int j = 0; j < LSTRIDE; j++) {
                PyObject *num = PyLong_FromLongLong(slot[j]);
                if (num == NULL) {
                    Py_DECREF(t);
                    goto fail;
                }
                PyTuple_SET_ITEM(t, j, num);
            }
            if (PyList_Append(recs, t) < 0) {
                Py_DECREF(t);
                goto fail;
            }
            Py_DECREF(t);
        }
        for (int k = 0; k < NKINDS; k++) {
            int64_t lost = (r->kind_writes[k] - r->kind_base[k]) - surv[k];
            if (lost > 0)
                kind_lost[k] += lost;
        }
    }
    {
        PyObject *lost = PyList_New(NKINDS);
        if (lost == NULL)
            goto fail;
        for (int k = 0; k < NKINDS; k++) {
            PyObject *num = PyLong_FromLongLong(kind_lost[k]);
            if (num == NULL) {
                Py_DECREF(lost);
                goto fail;
            }
            PyList_SET_ITEM(lost, k, num);
        }
        PyObject *out = PyTuple_Pack(2, recs, lost);
        Py_DECREF(recs);
        Py_DECREF(lost);
        return out;
    }
fail:
    Py_DECREF(recs);
    return NULL;
}

static PyObject *LedgerCore_drain_since(LedgerCoreObject *self,
                                        PyObject *cursors) {
    /* drain_since(cursors) -> (records, new_cursors, dropped).
     *
     * Cursor-based incremental read for the watchtower delta stream
     * (ISSUE 17): ``cursors`` is the per-ring cursor vector from the
     * previous call (ring indices are stable — ``all`` is append-only,
     * dead threads' rings are parked for adoption, never removed).  A
     * ring beyond the vector's length is new to the caller and reads
     * from its base.  Unlike drain(), nothing is consumed and base is
     * untouched, so full snapshots and the final trace dump still see
     * everything; ``dropped`` counts exactly the records that were
     * overwritten between the caller's cursor and the oldest readable
     * record (records below base were clear()ed, not dropped). */
    if (!PyList_Check(cursors)) {
        PyErr_SetString(PyExc_TypeError, "drain_since(cursors: list[int])");
        return NULL;
    }
    Py_ssize_t ncur = PyList_GET_SIZE(cursors);
    PyObject *recs = PyList_New(0);
    if (recs == NULL)
        return NULL;
    PyObject *newc = PyList_New(self->n_all);
    if (newc == NULL) {
        Py_DECREF(recs);
        return NULL;
    }
    int64_t dropped = 0;
    for (Py_ssize_t ri = 0; ri < self->n_all; ri++) {
        LRing *r = self->all[ri];
        int64_t cur = r->cursor;
        int64_t prev = -1;
        if (ri < ncur) {
            prev = PyLong_AsLongLong(PyList_GET_ITEM(cursors, ri));
            if (prev == -1 && PyErr_Occurred())
                goto fail;
        }
        int64_t p = prev > r->base ? prev : r->base;
        if (p > cur)
            p = cur;
        int64_t lo = p;
        if (cur - r->cap > lo)
            lo = cur - r->cap;
        dropped += lo - p;
        for (int64_t c = lo; c < cur; c++) {
            const int64_t *slot = r->data + (c % r->phys) * LSTRIDE;
            PyObject *t = PyTuple_New(LSTRIDE);
            if (t == NULL)
                goto fail;
            for (int j = 0; j < LSTRIDE; j++) {
                PyObject *num = PyLong_FromLongLong(slot[j]);
                if (num == NULL) {
                    Py_DECREF(t);
                    goto fail;
                }
                PyTuple_SET_ITEM(t, j, num);
            }
            if (PyList_Append(recs, t) < 0) {
                Py_DECREF(t);
                goto fail;
            }
            Py_DECREF(t);
        }
        PyObject *num = PyLong_FromLongLong(cur);
        if (num == NULL)
            goto fail;
        PyList_SET_ITEM(newc, ri, num);
    }
    {
        PyObject *nd = PyLong_FromLongLong(dropped);
        if (nd == NULL)
            goto fail;
        PyObject *out = PyTuple_Pack(3, recs, newc, nd);
        Py_DECREF(recs);
        Py_DECREF(newc);
        Py_DECREF(nd);
        return out;
    }
fail:
    Py_DECREF(recs);
    Py_DECREF(newc);
    return NULL;
}

static PyObject *LedgerCore_clear(LedgerCoreObject *self, PyObject *noarg) {
    (void)noarg;
    for (Py_ssize_t i = 0; i < self->n_all; i++) {
        LRing *r = self->all[i];
        r->base = r->cursor;
        memcpy(r->kind_base, r->kind_writes, sizeof(r->kind_base));
    }
    Py_RETURN_NONE;
}

static PyObject *LedgerCore_dropped(LedgerCoreObject *self, PyObject *noarg) {
    (void)noarg;
    int64_t lost = 0;
    for (Py_ssize_t i = 0; i < self->n_all; i++) {
        LRing *r = self->all[i];
        int64_t d = (r->cursor - r->base) - r->cap;
        if (d > 0)
            lost += d;
    }
    return PyLong_FromLongLong(lost);
}

static PyObject *LedgerCore_ring_count(LedgerCoreObject *self,
                                       PyObject *noarg) {
    (void)noarg;
    return PyLong_FromSsize_t(self->n_all);
}

static PyMethodDef LedgerCore_methods[] = {
    {"rec", (PyCFunction)LedgerCore_rec, METH_FASTCALL,
     "rec(kind, code, step, t0, t1, a, b): append one record."},
    {"rec_pack", (PyCFunction)LedgerCore_rec_pack, METH_FASTCALL,
     "rec_pack(header_bytes, blob_bytes, t0, t1) using the thread ctx."},
    {"rec_unpack", (PyCFunction)LedgerCore_rec_unpack, METH_FASTCALL,
     "rec_unpack(header_bytes, blob_bytes, t0, t1) using the thread ctx."},
    {"rec_encode", (PyCFunction)LedgerCore_rec_encode, METH_FASTCALL,
     "rec_encode(t0, t1[, copies]) using the thread ctx."},
    {"rec_decode", (PyCFunction)LedgerCore_rec_decode, METH_FASTCALL,
     "rec_decode(t0, t1) using the thread ctx."},
    {"rec_scope", (PyCFunction)LedgerCore_rec_scope, METH_FASTCALL,
     "rec_scope(kind, t0): scope-exit record, t1 taken natively."},
    {"rec_retry", (PyCFunction)LedgerCore_rec_retry, METH_FASTCALL,
     "rec_retry(code, backoff_us) using the thread ctx step."},
    {"swap_ctx", (PyCFunction)LedgerCore_swap_ctx, METH_FASTCALL,
     "swap_ctx(code, step) -> (prev_code, prev_step); step -2 keeps."},
    {"set_step", (PyCFunction)LedgerCore_set_step, METH_FASTCALL,
     "set_step(step) -> prev_step"},
    {"scope", (PyCFunction)LedgerCore_scope, METH_FASTCALL,
     "scope(kind, code, step) -> LedgerScope (kind -1 = tag-only)."},
    {"drain", (PyCFunction)LedgerCore_drain, METH_NOARGS,
     "-> (records, kind_lost)"},
    {"drain_since", (PyCFunction)LedgerCore_drain_since, METH_O,
     "drain_since(cursors) -> (records, new_cursors, dropped)"},
    {"clear", (PyCFunction)LedgerCore_clear, METH_NOARGS, NULL},
    {"dropped", (PyCFunction)LedgerCore_dropped, METH_NOARGS, NULL},
    {"ring_count", (PyCFunction)LedgerCore_ring_count, METH_NOARGS, NULL},
    {NULL, NULL, 0, NULL},
};

static PyTypeObject LedgerCore_Type = {
    PyVarObject_HEAD_INIT(NULL, 0)
    .tp_name = "_tepdist_torch_fastobs.LedgerCore",
    .tp_basicsize = sizeof(LedgerCoreObject),
    .tp_flags = Py_TPFLAGS_DEFAULT,
    .tp_doc = "Per-thread int64 record rings (ledger write path).",
    .tp_new = PyType_GenericNew,
    .tp_init = (initproc)LedgerCore_init,
    .tp_dealloc = (destructor)LedgerCore_dealloc,
    .tp_methods = LedgerCore_methods,
};

/* ----------------------------------------------------------------- trace */

typedef struct {
    PyObject **objs;                  /* phys * 3: name, cat, attrs */
    int64_t *ts;                      /* phys * 2: t0, dur */
    int64_t cursor, base;
    int64_t cap, phys;
    PyObject *seg_tids;               /* list[str], one per owner segment */
    int64_t *seg_starts; Py_ssize_t n_seg, sz_seg;
} TRing;

typedef struct {
    PyObject_HEAD
    int64_t cap;
    TRing **all;   Py_ssize_t n_all, sz_all;
    TRing **freel; Py_ssize_t n_free, sz_free;
    PyThreadState *cache_ts;
    TRing *cache_ring;
} TraceCoreObject;

typedef struct {
    TRing *ring;
    PyObject *core;
} TRingBox;

static const char TCAP_NAME[] = "tepdist.fastobs.tring";

static void tring_free(TRing *r) {
    if (r->objs != NULL) {
        for (int64_t i = 0; i < r->phys * 3; i++)
            Py_XDECREF(r->objs[i]);
        free(r->objs);
    }
    free(r->ts);
    Py_XDECREF(r->seg_tids);
    free(r->seg_starts);
    free(r);
}

static TRing *tring_new(int64_t cap, PyObject *tid) {
    TRing *r = (TRing *)calloc(1, sizeof(TRing));
    if (r == NULL)
        return NULL;
    r->cap = cap;
    r->phys = cap + 1;
    r->objs = (PyObject **)calloc((size_t)(r->phys * 3), sizeof(PyObject *));
    r->ts = (int64_t *)malloc(sizeof(int64_t) * 2 * (size_t)r->phys);
    r->seg_tids = PyList_New(0);
    r->seg_starts = (int64_t *)malloc(sizeof(int64_t) * 4);
    if (r->objs == NULL || r->ts == NULL || r->seg_tids == NULL ||
        r->seg_starts == NULL || PyList_Append(r->seg_tids, tid) < 0) {
        tring_free(r);
        return NULL;
    }
    r->seg_starts[0] = 0;
    r->n_seg = 1;
    r->sz_seg = 4;
    return r;
}

static int tring_add_segment(TRing *r, PyObject *tid) {
    if (r->n_seg == r->sz_seg) {
        Py_ssize_t ns = r->sz_seg * 2;
        int64_t *na = (int64_t *)realloc(r->seg_starts,
                                         sizeof(int64_t) * (size_t)ns);
        if (na == NULL)
            return -1;
        r->seg_starts = na;
        r->sz_seg = ns;
    }
    if (PyList_Append(r->seg_tids, tid) < 0)
        return -1;
    r->seg_starts[r->n_seg++] = r->cursor;
    return 0;
}

static void tring_capsule_destruct(PyObject *capsule) {
    TRingBox *box = (TRingBox *)PyCapsule_GetPointer(capsule, TCAP_NAME);
    if (box == NULL) {
        PyErr_Clear();
        return;
    }
    TraceCoreObject *core = (TraceCoreObject *)box->core;
    ptr_push((void ***)&core->freel, &core->n_free, &core->sz_free,
             box->ring);
    if (core->cache_ring == box->ring) {
        core->cache_ts = NULL;
        core->cache_ring = NULL;
    }
    Py_DECREF(box->core);
    free(box);
}

static TRing *trace_tls_ring(TraceCoreObject *self) {
    PyThreadState *ts = PyThreadState_Get();
    if (ts == self->cache_ts)
        return self->cache_ring;
    PyObject *td = PyThreadState_GetDict();
    if (td == NULL) {
        PyErr_SetString(PyExc_RuntimeError, "no thread-state dict");
        return NULL;
    }
    PyObject *cap = PyDict_GetItemWithError(td, (PyObject *)self);
    TRing *r;
    if (cap != NULL) {
        TRingBox *box = (TRingBox *)PyCapsule_GetPointer(cap, TCAP_NAME);
        if (box == NULL)
            return NULL;
        r = box->ring;
    } else {
        if (PyErr_Occurred())
            return NULL;
        PyObject *tid = cur_thread_name();
        if (tid == NULL)
            return NULL;
        if (self->n_free > 0) {
            r = self->freel[--self->n_free];
            PyObject *last = PyList_GET_ITEM(
                r->seg_tids, PyList_GET_SIZE(r->seg_tids) - 1);
            int same = PyObject_RichCompareBool(last, tid, Py_EQ);
            if (same < 0 || (same == 0 && tring_add_segment(r, tid) < 0)) {
                Py_DECREF(tid);
                self->freel[self->n_free++] = r;   /* re-park, fail */
                return NULL;
            }
        } else {
            r = tring_new(self->cap, tid);
            if (r == NULL) {
                Py_DECREF(tid);
                PyErr_NoMemory();
                return NULL;
            }
            if (ptr_push((void ***)&self->all, &self->n_all, &self->sz_all,
                         r) < 0) {
                Py_DECREF(tid);
                tring_free(r);
                PyErr_NoMemory();
                return NULL;
            }
        }
        Py_DECREF(tid);
        TRingBox *box = (TRingBox *)malloc(sizeof(TRingBox));
        if (box == NULL) {
            PyErr_NoMemory();
            return NULL;
        }
        box->ring = r;
        box->core = (PyObject *)self;
        Py_INCREF(self);
        PyObject *capo = PyCapsule_New(box, TCAP_NAME, tring_capsule_destruct);
        if (capo == NULL) {
            Py_DECREF(self);
            free(box);
            return NULL;
        }
        if (PyDict_SetItem(td, (PyObject *)self, capo) < 0) {
            Py_DECREF(capo);
            return NULL;
        }
        Py_DECREF(capo);
    }
    self->cache_ts = ts;
    self->cache_ring = r;
    return r;
}

/* FastSpan ---------------------------------------------------------------- */

typedef struct {
    PyObject_HEAD
    TraceCoreObject *core;            /* strong */
    PyObject *name, *cat, *attrs;
    int64_t t0, dur;
} FastSpanObject;

static PyTypeObject FastSpan_Type;   /* fwd */

static void FastSpan_dealloc(FastSpanObject *self) {
    Py_XDECREF(self->core);
    Py_XDECREF(self->name);
    Py_XDECREF(self->cat);
    Py_XDECREF(self->attrs);
    Py_TYPE(self)->tp_free((PyObject *)self);
}

static PyObject *FastSpan_enter(FastSpanObject *self, PyObject *noarg) {
    (void)noarg;
    self->t0 = mono_ns();
    Py_INCREF(self);
    return (PyObject *)self;
}

static PyObject *FastSpan_exit(FastSpanObject *self, PyObject *const *args,
                               Py_ssize_t nargs) {
    (void)args;
    (void)nargs;
    int64_t t0 = self->t0;
    int64_t dur = mono_ns() - t0;
    self->dur = dur;
    TRing *r = trace_tls_ring(self->core);
    if (r == NULL)
        return NULL;
    int64_t c = r->cursor;
    Py_ssize_t slot = (Py_ssize_t)(c % r->phys);
    PyObject **o = r->objs + slot * 3;
    int64_t *t = r->ts + slot * 2;
    Py_INCREF(self->name);
    Py_INCREF(self->cat);
    Py_INCREF(self->attrs);
    Py_XDECREF(o[0]);
    Py_XDECREF(o[1]);
    Py_XDECREF(o[2]);
    o[0] = self->name;
    o[1] = self->cat;
    o[2] = self->attrs;
    t[0] = t0;
    t[1] = dur;
    r->cursor = c + 1;              /* publish after the slot writes */
    Py_RETURN_FALSE;
}

static PyObject *FastSpan_set(FastSpanObject *self, PyObject *args,
                              PyObject *kwds) {
    if (PyTuple_GET_SIZE(args) != 0) {
        PyErr_SetString(PyExc_TypeError, "set() takes keyword args only");
        return NULL;
    }
    if (kwds != NULL && PyDict_Update(self->attrs, kwds) < 0)
        return NULL;
    Py_INCREF(self);
    return (PyObject *)self;
}

static PyObject *FastSpan_dur_us(FastSpanObject *self, void *closure) {
    (void)closure;
    return PyFloat_FromDouble((double)self->dur / 1e3);
}

static PyObject *FastSpan_dur_ms(FastSpanObject *self, void *closure) {
    (void)closure;
    return PyFloat_FromDouble((double)self->dur / 1e6);
}

static PyObject *FastSpan_elapsed_ms(FastSpanObject *self, void *closure) {
    (void)closure;
    return PyFloat_FromDouble((double)(mono_ns() - self->t0) / 1e6);
}

static PyGetSetDef FastSpan_getset[] = {
    {"dur_us", (getter)FastSpan_dur_us, NULL, NULL, NULL},
    {"dur_ms", (getter)FastSpan_dur_ms, NULL, NULL, NULL},
    {"elapsed_ms", (getter)FastSpan_elapsed_ms, NULL, NULL, NULL},
    {NULL, NULL, NULL, NULL, NULL},
};

static PyMemberDef FastSpan_members[] = {
    {"name", T_OBJECT_EX, offsetof(FastSpanObject, name), 0, NULL},
    {"cat", T_OBJECT_EX, offsetof(FastSpanObject, cat), 0, NULL},
    {"attrs", T_OBJECT_EX, offsetof(FastSpanObject, attrs), 0, NULL},
    {NULL, 0, 0, 0, NULL},
};

static PyMethodDef FastSpan_methods[] = {
    {"__enter__", (PyCFunction)FastSpan_enter, METH_NOARGS, NULL},
    {"__exit__", (PyCFunction)FastSpan_exit, METH_FASTCALL, NULL},
    {"set", (PyCFunction)FastSpan_set, METH_VARARGS | METH_KEYWORDS,
     "Attach attributes mid-span; returns self."},
    {NULL, NULL, 0, NULL},
};

static PyTypeObject FastSpan_Type = {
    PyVarObject_HEAD_INIT(NULL, 0)
    .tp_name = "_tepdist_torch_fastobs.FastSpan",
    .tp_basicsize = sizeof(FastSpanObject),
    .tp_flags = Py_TPFLAGS_DEFAULT,
    .tp_doc = "One recorded interval (native trace.Span counterpart).",
    .tp_dealloc = (destructor)FastSpan_dealloc,
    .tp_methods = FastSpan_methods,
    .tp_members = FastSpan_members,
    .tp_getset = FastSpan_getset,
};

/* TraceCore --------------------------------------------------------------- */

static int TraceCore_init(TraceCoreObject *self, PyObject *args,
                          PyObject *kwds) {
    long long cap = 0;
    static char *kwlist[] = {"capacity", NULL};
    if (!PyArg_ParseTupleAndKeywords(args, kwds, "L", kwlist, &cap))
        return -1;
    if (cap < 1) {
        PyErr_SetString(PyExc_ValueError, "capacity must be >= 1");
        return -1;
    }
    self->cap = (int64_t)cap;
    return 0;
}

static void TraceCore_dealloc(TraceCoreObject *self) {
    for (Py_ssize_t i = 0; i < self->n_all; i++)
        tring_free(self->all[i]);
    free(self->all);
    free(self->freel);
    Py_TYPE(self)->tp_free((PyObject *)self);
}

static PyObject *TraceCore_span(TraceCoreObject *self, PyObject *const *args,
                                Py_ssize_t nargs) {
    if (nargs != 3) {
        PyErr_SetString(PyExc_TypeError, "span(name, cat, attrs)");
        return NULL;
    }
    FastSpanObject *sp =
        (FastSpanObject *)FastSpan_Type.tp_alloc(&FastSpan_Type, 0);
    if (sp == NULL)
        return NULL;
    Py_INCREF(self);
    sp->core = self;
    Py_INCREF(args[0]);
    sp->name = args[0];
    Py_INCREF(args[1]);
    sp->cat = args[1];
    Py_INCREF(args[2]);
    sp->attrs = args[2];
    sp->t0 = 0;
    sp->dur = 0;
    return (PyObject *)sp;
}

static PyObject *TraceCore_drain(TraceCoreObject *self, PyObject *noarg) {
    /* -> list of raw (t0, ridx, seq, name, cat, dur, attrs, tid) tuples,
     * the same shape Tracer.snapshot() builds from the Python rings, so
     * the two sources concatenate and sort together. */
    (void)noarg;
    PyObject *out = PyList_New(0);
    if (out == NULL)
        return NULL;
    for (Py_ssize_t ri = 0; ri < self->n_all; ri++) {
        TRing *r = self->all[ri];
        int64_t cur = r->cursor;
        int64_t lo = r->base;
        if (cur - r->cap > lo)
            lo = cur - r->cap;
        Py_ssize_t seg = 0;
        while (seg + 1 < r->n_seg && r->seg_starts[seg + 1] <= lo)
            seg++;
        for (int64_t c = lo; c < cur; c++) {
            while (seg + 1 < r->n_seg && r->seg_starts[seg + 1] <= c)
                seg++;
            Py_ssize_t slot = (Py_ssize_t)(c % r->phys);
            PyObject **o = r->objs + slot * 3;
            const int64_t *t = r->ts + slot * 2;
            PyObject *tup = Py_BuildValue(
                "LnLOOLOO", (long long)t[0], ri, (long long)c, o[0], o[1],
                (long long)t[1], o[2], PyList_GET_ITEM(r->seg_tids, seg));
            if (tup == NULL)
                goto fail;
            if (PyList_Append(out, tup) < 0) {
                Py_DECREF(tup);
                goto fail;
            }
            Py_DECREF(tup);
        }
    }
    return out;
fail:
    Py_DECREF(out);
    return NULL;
}

static PyObject *TraceCore_drain_since(TraceCoreObject *self,
                                       PyObject *cursors) {
    /* drain_since(cursors) -> (records, new_cursors, dropped): the
     * cursor-parameterized counterpart of drain() (same tuple shape),
     * for incremental watchtower reads — see LedgerCore_drain_since
     * for the cursor/base/drop contract. */
    if (!PyList_Check(cursors)) {
        PyErr_SetString(PyExc_TypeError, "drain_since(cursors: list[int])");
        return NULL;
    }
    Py_ssize_t ncur = PyList_GET_SIZE(cursors);
    PyObject *recs = PyList_New(0);
    if (recs == NULL)
        return NULL;
    PyObject *newc = PyList_New(self->n_all);
    if (newc == NULL) {
        Py_DECREF(recs);
        return NULL;
    }
    int64_t dropped = 0;
    for (Py_ssize_t ri = 0; ri < self->n_all; ri++) {
        TRing *r = self->all[ri];
        int64_t cur = r->cursor;
        int64_t prev = -1;
        if (ri < ncur) {
            prev = PyLong_AsLongLong(PyList_GET_ITEM(cursors, ri));
            if (prev == -1 && PyErr_Occurred())
                goto fail;
        }
        int64_t p = prev > r->base ? prev : r->base;
        if (p > cur)
            p = cur;
        int64_t lo = p;
        if (cur - r->cap > lo)
            lo = cur - r->cap;
        dropped += lo - p;
        Py_ssize_t seg = 0;
        while (seg + 1 < r->n_seg && r->seg_starts[seg + 1] <= lo)
            seg++;
        for (int64_t c = lo; c < cur; c++) {
            while (seg + 1 < r->n_seg && r->seg_starts[seg + 1] <= c)
                seg++;
            Py_ssize_t slot = (Py_ssize_t)(c % r->phys);
            PyObject **o = r->objs + slot * 3;
            const int64_t *t = r->ts + slot * 2;
            PyObject *tup = Py_BuildValue(
                "LnLOOLOO", (long long)t[0], ri, (long long)c, o[0], o[1],
                (long long)t[1], o[2], PyList_GET_ITEM(r->seg_tids, seg));
            if (tup == NULL)
                goto fail;
            if (PyList_Append(recs, tup) < 0) {
                Py_DECREF(tup);
                goto fail;
            }
            Py_DECREF(tup);
        }
        PyObject *num = PyLong_FromLongLong(cur);
        if (num == NULL)
            goto fail;
        PyList_SET_ITEM(newc, ri, num);
    }
    {
        PyObject *nd = PyLong_FromLongLong(dropped);
        if (nd == NULL)
            goto fail;
        PyObject *out = PyTuple_Pack(3, recs, newc, nd);
        Py_DECREF(recs);
        Py_DECREF(newc);
        Py_DECREF(nd);
        return out;
    }
fail:
    Py_DECREF(recs);
    Py_DECREF(newc);
    return NULL;
}

static PyObject *TraceCore_dropped(TraceCoreObject *self, PyObject *noarg) {
    (void)noarg;
    int64_t lost = 0;
    for (Py_ssize_t i = 0; i < self->n_all; i++) {
        TRing *r = self->all[i];
        int64_t d = (r->cursor - r->base) - r->cap;
        if (d > 0)
            lost += d;
    }
    return PyLong_FromLongLong(lost);
}

static PyObject *TraceCore_live(TraceCoreObject *self, PyObject *noarg) {
    (void)noarg;
    int64_t n = 0;
    for (Py_ssize_t i = 0; i < self->n_all; i++) {
        TRing *r = self->all[i];
        int64_t d = r->cursor - r->base;
        n += d < r->cap ? d : r->cap;
    }
    return PyLong_FromLongLong(n);
}

static PyObject *TraceCore_clear(TraceCoreObject *self, PyObject *noarg) {
    (void)noarg;
    for (Py_ssize_t i = 0; i < self->n_all; i++) {
        TRing *r = self->all[i];
        r->base = r->cursor;
    }
    Py_RETURN_NONE;
}

static PyMethodDef TraceCore_methods[] = {
    {"span", (PyCFunction)TraceCore_span, METH_FASTCALL,
     "span(name, cat, attrs) -> FastSpan"},
    {"drain", (PyCFunction)TraceCore_drain, METH_NOARGS, NULL},
    {"drain_since", (PyCFunction)TraceCore_drain_since, METH_O,
     "drain_since(cursors) -> (records, new_cursors, dropped)"},
    {"dropped", (PyCFunction)TraceCore_dropped, METH_NOARGS, NULL},
    {"live", (PyCFunction)TraceCore_live, METH_NOARGS, NULL},
    {"clear", (PyCFunction)TraceCore_clear, METH_NOARGS, NULL},
    {NULL, NULL, 0, NULL},
};

static PyTypeObject TraceCore_Type = {
    PyVarObject_HEAD_INIT(NULL, 0)
    .tp_name = "_tepdist_torch_fastobs.TraceCore",
    .tp_basicsize = sizeof(TraceCoreObject),
    .tp_flags = Py_TPFLAGS_DEFAULT,
    .tp_doc = "Per-thread span rings (trace write path).",
    .tp_new = PyType_GenericNew,
    .tp_init = (initproc)TraceCore_init,
    .tp_dealloc = (destructor)TraceCore_dealloc,
    .tp_methods = TraceCore_methods,
};

/* ---------------------------------------------------------------- module */

static struct PyModuleDef fastobs_module = {
    PyModuleDef_HEAD_INIT,
    .m_name = "_tepdist_torch_fastobs",
    .m_doc = "Native write-path cores for tepdist telemetry.",
    .m_size = -1,
};

PyMODINIT_FUNC PyInit__tepdist_torch_fastobs(void) {
    PyObject *threading = PyImport_ImportModule("threading");
    if (threading == NULL)
        return NULL;
    g_current_thread = PyObject_GetAttrString(threading, "current_thread");
    Py_DECREF(threading);
    if (g_current_thread == NULL)
        return NULL;
    if (PyType_Ready(&LedgerCore_Type) < 0 ||
        PyType_Ready(&LedgerScope_Type) < 0 ||
        PyType_Ready(&TraceCore_Type) < 0 ||
        PyType_Ready(&FastSpan_Type) < 0)
        return NULL;
    PyObject *m = PyModule_Create(&fastobs_module);
    if (m == NULL)
        return NULL;
    Py_INCREF(&LedgerCore_Type);
    Py_INCREF(&TraceCore_Type);
    Py_INCREF(&FastSpan_Type);
    if (PyModule_AddObject(m, "LedgerCore",
                           (PyObject *)&LedgerCore_Type) < 0 ||
        PyModule_AddObject(m, "TraceCore", (PyObject *)&TraceCore_Type) < 0 ||
        PyModule_AddObject(m, "FastSpan", (PyObject *)&FastSpan_Type) < 0) {
        Py_DECREF(m);
        return NULL;
    }
    return m;
}
